#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the kernels from ``vit_with_opencl_tpu_torch/csrc`` itself (first
use), then runs these phases; any failure exits non-zero before the last
line.

1. Device and build: the card's name and power limit, the build time.
2. Kernels against their plain versions at ViT-B/16 shapes (T = 197,
   D = 768, H = 3072) at the main path's batch of 16: both LN links, the four
   GEMMs of a layer, the packed attention and the whole bf16 encoder-layer
   chain. Each prints its max abs error beside its tolerance and its time
   (CUDA events) beside its bound, its plain version's time and a library
   yardstick: one PyTorch call where one computes the same function
   (``F.layer_norm``, ``torch.addmm``, ``F.scaled_dot_product_attention``),
   else ``torch.addmm`` followed by the rest of the epilogue as PyTorch ops.
2b. The int8 kernels the same way, on the W8A8 and weight-only chains' own
   intermediates: the row quantize at its four sites (bit-identical to its
   plain version), the four W8A8 GEMMs (bit-identical without GELU), the
   four int8-weight GEMMs, the W8A8 chain's two LN links (fp32 out) and
   both int8 chains. Yardsticks: ``torch._int_mm`` (cuBLASLt int8) with the
   epilogue as PyTorch ops for W8A8, ``torch.mm`` on a bf16 copy of the
   weight with the epilogue as ops for weight-only int8; none for the
   quantize.
2c. The calibrated outlier-aware W8A8 kernels the same way, on the
   intermediates of layer 0 of calibrated adversarial ViT-B weights (the
   phase-3c workspace's): the split quantize at LN1, LN2 and the GELU'd
   hidden and the masked quantize at the context (bit-identical to their
   plain versions), the four W8A8 GEMMs with their bf16 side products, and
   the outlier chain. Yardsticks: ``torch._int_mm`` plus ``torch.mm`` on the
   bf16 side, with the epilogue as PyTorch ops; none for the quantizes.
3. The main path: a reference-format workspace (seeded ViT-B/16 weights,
   40 seeded images) goes through ``cli.main --backend gpu --attention
   flash``; the answer file comes from the port's plain fp32 path on the
   card with TF32 off. Requires "Comparator: files match.", bf16
   probabilities within 1e-3 of the fp32 path, and the kernel launch counts
   of 3 batches x 12 layers.
3b. The int8 main path: the same workspace and answer file through
   ``--quantize int8-w8a8``, ``int8`` and ``auto`` (which resolves to W8A8
   on ViT-B). Each needs "Comparator: files match." and its launch counts;
   the W8A8 probabilities must be within 1e-3 of the same engine with the
   chain's links swapped for their plain versions.
3c. The calibrated outlier-aware W8A8 main path: a workspace of seeded
   adversarial ViT-B/16 weights (``fixtures.adversarial_params``, trained-ViT
   outlier channels; the head scaled by HEAD_SCALE so probabilities are
   confident), 40 decisive images, a seeded calibration binary, and an fp32
   answer file, through ``--quantize int8-w8a8 --calibrate`` and
   ``--quantize auto --calibrate``. Each needs "Comparator: files match."
   and the launch counts of 3 batches x 12 outlier chains; the
   probabilities must be within 1e-3 of the same engine on the chain's plain
   versions. How far plain (uncalibrated) W8A8 moves on the same weights is
   printed, not gated.
3d. The small configs' main path: a workspace of seeded ViT-Ti/16 (and
   ViT-S/16) weights, 40 decisive images and an fp32 answer file through
   the CLI with no flags, ``--quantize auto`` (unquantized on these
   configs) and ``--quantize int8``. Each needs "Comparator: files match."
   and the stack's launch counts: one stack call per forward, no per-layer
   chain; the probabilities must be within 1e-3 of the same engine on the
   stack's plain version. ``--quantize int8-w8a8`` on ViT-S runs the
   per-layer W8A8 chain (its counts), as in the JAX package.
2d. The whole-encoder stack of the small configs (ViT-Ti/16 and ViT-S/16,
   T = 197) the same way at batch 16: every kernel of phases 2 and 2b at
   these configs' shapes; the full-depth bf16 and int8-weight stacks
   against ``fused_encoder_stack_reference``, each also held nearer to it
   than the plain per-layer chain is (the stream rounded at every layer,
   the fault the stack exists to avoid); the stack at one layer
   (``fused_encoder_layer_flat``); the W8A8 stack and a ``group_size=2``
   layer group at depth 4 against theirs; for comparison the per-layer
   chain over the same 12 layers against its plain version. No yardstick
   for the stacks.
4. Throughput of the full-depth bf16, W8A8, int8 and calibrated W8A8 flash
   forwards at batch 64 and 256, beside the sums of their kernels' times and
   bounds at the same batch; then ViT-Ti and ViT-S (bf16 and int8-weight
   stacks) at batch 64 and 256, beside the same engines on the per-layer
   chain, with the rows of phase 2d timed again at batch 256.

Counts are set to 0 just before each main-path run and read just after.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

try:
    from vit_with_opencl_tpu_torch import VIT_B_16_224, cli
    from vit_with_opencl_tpu_torch.config import VIT_S_16_224, VIT_TINY_16_224
    from vit_with_opencl_tpu_torch.engine import InferenceEngine
    from vit_with_opencl_tpu_torch.harness import fixtures, results
    from vit_with_opencl_tpu_torch.io import binfmt
    from vit_with_opencl_tpu_torch.models import quant, vit
    from vit_with_opencl_tpu_torch.ops import (_build, attention, fused_block,
                                               layernorm, linear, quantize)
except ImportError as exc:  # run outside the repository
    print(f"FAIL: the port's package is not importable here: {exc}")
    sys.exit(1)

CFG = VIT_B_16_224
SMOKE_BATCH = 16  # the main path's batch (phase 3), hence phase 2's shapes
N_IMAGES = 40  # 3 batches of 16, the last one padded
THROUGHPUT_BATCHES = (64, 256)
REPS = 20
PLAIN_REPS = 5  # the plain versions are slow and no yardstick of speed
# Images whose fp32 top-2 logit gap is below this are left out of phases 3
# and 3b: with random weights over 1000 classes, near-ties are common, and
# bf16 rounding or int8 quantization may then swap the top-1 label although
# the probabilities agree to 1e-4. The comparator's exact-label gate should
# test the kernels, not a coin toss.
MIN_LOGIT_GAP = 0.05

# bf16 outputs: about 2 bf16 ulps; fp32 outputs: summation order.
BF16_TOL = (1.6e-2, 1e-2)  # (rtol, atol)
F32_TOL = (1e-4, 1e-4)
EXACT = (0.0, 0.0)
# A bf16 output must also be bit-identical to the plain version's almost
# everywhere: both round at the same points, and only another summation
# order may flip a rounding. A moved rounding point stays within 2 ulps but
# changes about half the elements. The chain compounds the flips of its 7
# launches (about 82% identical at ViT-B shapes on an H100).
MIN_SAME_KERNEL = 0.99
MIN_SAME_CHAIN = 0.7
# The int8 chains. Weight-only int8 rounds where the bf16 chain does (87%
# identical at ViT-B shapes on an H100). W8A8 adds four quantizes: an fp32
# LN output or GELU'd hidden one ulp off the plain version's (another
# summation order, a contracted multiply-add) now and then flips an int8
# decision, and a flip moves the products of its row by a quantum. Measured
# on an H100 80GB HBM3: 88-89% identical, max abs error 1.56e-2 at B = 16
# and 64, 1.76e-2 at B = 256, on outputs small enough that 2 bf16 ulps do
# not cover it; hence an atol of 3e-2 for this chain alone.
MIN_SAME_INT8_CHAIN = 0.8
W8A8_CHAIN_TOL = (1.6e-2, 3e-2)
PROB_TOL = 1e-3  # the reference's bf16 parity budget on probabilities
# The outlier-aware W8A8 GEMMs: the int8 sums are exact, but the bf16 side
# product sums in another order than the plain version's fp32 GEMM, so fp32
# outputs agree to summation order (44-58% bit-identical) and bf16 outputs
# almost always round the same way. The outlier chain compounds that with
# the int8 flips of the W8A8 chain, on the adversarial weights' larger
# activations. Measured on an H100 80GB HBM3: 91-94% identical, max abs
# error 0.078 / 0.109 / 0.125 at B = 16 / 64 / 256; hence an atol of 0.25.
OUTLIER_CHAIN_TOL = (1.6e-2, 0.25)
MIN_SAME_OUTLIER_CHAIN = 0.85
# Phase 3c's workspace: the adversarial fixture's classifier head is scaled
# so that quantization errors show in the probabilities. The JAX package's
# tests scale it by 6 at D = 256; at ViT-B width on an H100 80GB HBM3 that
# puts even unquantized bf16 0.030 from fp32 (the gate is 0.01), and at 3
# the calibrated plain chain is 0.0116 from it. At 1.5 the calibrated mode
# is 7e-4 from fp32 and plain W8A8 still flips 6 of 40 labels.
HEAD_SCALE = 1.5
N_CALIB = 16
# Phases 2d, 3d and 4: the configs whose whole encoder runs as the stack.
SMALL_CFGS = (VIT_TINY_16_224, VIT_S_16_224)
# The stacks carry the fp32 stream through every layer: a bf16 rounding of
# an LN output, qkv, the context or the hidden that another summation order
# flips moves the stream a little, and each later layer carries the move on.
# The outputs stay within 2 bf16 ulps, but the bit-identical share falls with
# depth. Measured on an H100 80GB HBM3 (first run of these phases): 12-layer
# stacks 68% (ViT-Ti) and 50% (ViT-S) identical, the 4-layer group 83% and
# 63%, the 4-layer W8A8 stack 71% and 26% (its int8 flips compound too).
# The per-layer chain over the same 12 layers, printed beside them, keeps
# less: 45% and 29%, max abs error 3.1e-2 and 4.7e-2. At one layer
# (fused_encoder_layer_flat: 99.6% and 96.4%) the stack is held to the
# chain's share.
MIN_SAME_STACK = 0.4
# The mean abs error of a bf16 or int8-weight stack or group against its
# plain version must also stay below this share of the distance between the
# plain per-layer chain (the stream rounded to the activation dtype at every
# layer) and the plain stack. Measured on an H100 80GB HBM3: the correct
# stacks 0.20 (ViT-Ti) and 0.38 (ViT-S), the groups 0.16 and 0.42; with the
# stream rounded at each fc2 of the kernel route, 1.0 for all four. The
# W8A8 stack is not held to it: its int8 flips alone put it at 0.25 and 0.73.
STACK_FAULT_SHARE = 0.8
STACK_W8A8_TOL = (1.6e-2, 6e-2)
MIN_SAME_STACK_W8A8 = 0.15
REDUCED_DEPTH = 4  # the W8A8 stack and the group in phase 2d

# Published dense peaks (NVIDIA data sheets): tensor-core bf16 FLOP/s,
# CUDA-core fp32 FLOP/s, tensor-core int8 OP/s, memory bytes/s.
PEAKS = {
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "int8": 1513e12, "bytes": 2.0e12},
    "H100 NVL": {"bf16": 835e12, "fp32": 60e12, "int8": 1671e12, "bytes": 3.9e12},
    "H100": {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "bytes": 3.35e12},
}

# Each kernel's launch counter: (module, attribute).
COUNTERS = {
    "layernorm": (layernorm, "LAUNCHES"),
    "linear": (linear, "LAUNCHES"),
    "attention": (attention, "LAUNCHES"),
    "fused_block": (fused_block, "LAUNCHES"),
    "quantize": (quantize, "LAUNCHES"),
    "linear_w8a8": (linear, "LAUNCHES_W8A8"),
    "linear_int8w": (linear, "LAUNCHES_INT8W"),
    "fused_block_w8a8": (fused_block, "LAUNCHES_W8A8"),
    "fused_block_int8w": (fused_block, "LAUNCHES_INT8W"),
    "quantize_split": (quantize, "LAUNCHES_SPLIT"),
    "quantize_masked": (quantize, "LAUNCHES_MASKED"),
    "linear_w8a8_hi": (linear, "LAUNCHES_W8A8_HI"),
    "fused_block_w8a8_outlier": (fused_block, "LAUNCHES_W8A8_OUTLIER"),
    "fused_block_stack": (fused_block, "LAUNCHES_STACK"),
    "fused_block_stack_int8w": (fused_block, "LAUNCHES_STACK_INT8W"),
    "fused_block_stack_w8a8": (fused_block, "LAUNCHES_STACK_W8A8"),
    "fused_block_group": (fused_block, "LAUNCHES_GROUP"),
}
_QUANTIZED_LAYER = "vit_with_opencl_tpu/ops/fused_block.py:198"
REPLACES = {
    "layernorm": "vit_with_opencl_tpu/ops/layernorm.py:33",
    "linear": "vit_with_opencl_tpu/ops/linear.py:36",
    "attention": "vit_with_opencl_tpu/ops/attention.py:872",
    "fused_block": "vit_with_opencl_tpu/ops/fused_block.py:198",
    "quantize": _QUANTIZED_LAYER, "linear_w8a8": _QUANTIZED_LAYER,
    "linear_int8w": _QUANTIZED_LAYER, "fused_block_w8a8": _QUANTIZED_LAYER,
    "fused_block_int8w": _QUANTIZED_LAYER,
    # _block_kernel with outlier=True: _mm with hi_ref (its quantize at :111,
    # its side GEMM at :114) and _mm_ctx_masked (:128).
    "quantize_split": "vit_with_opencl_tpu/ops/fused_block.py:111",
    "quantize_masked": "vit_with_opencl_tpu/ops/fused_block.py:128",
    "linear_w8a8_hi": "vit_with_opencl_tpu/ops/fused_block.py:109",
    "fused_block_w8a8_outlier": _QUANTIZED_LAYER,
    "fused_block_stack": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_stack_int8w": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_stack_w8a8": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_group": _QUANTIZED_LAYER,
}
_CSRC = "vit_with_opencl_tpu_torch/csrc/"
SOURCES = {
    "layernorm": _CSRC + "layernorm.cu",
    "linear": _CSRC + "linear.cu",
    "attention": _CSRC + "attention.cu",
    "fused_block": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "quantize": _CSRC + "quantize.cu",
    "linear_w8a8": _CSRC + "linear.cu",
    "linear_int8w": _CSRC + "linear.cu",
    "fused_block_w8a8": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_int8w": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "quantize_split": _CSRC + "quantize.cu",
    "quantize_masked": _CSRC + "quantize.cu",
    "linear_w8a8_hi": _CSRC + "linear.cu",
    "fused_block_w8a8_outlier": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_stack": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_stack_int8w": "vit_with_opencl_tpu_torch/ops/fused_block.py",
}
# The main-path runs: phase name → CLI flags (the outlier runs add
# --calibrate with their workspace's calibration binary).
MODES = {"bf16": [], "w8a8": ["--quantize", "int8-w8a8"],
         "int8": ["--quantize", "int8"], "auto": ["--quantize", "auto"],
         "w8a8_outlier": ["--quantize", "int8-w8a8"],
         "auto_outlier": ["--quantize", "auto"]}
# Which run each kernel's launch count is read from, and its count per layer.
PER_LAYER = {
    "bf16": {"layernorm": 2, "linear": 4, "attention": 1, "fused_block": 1},
    "w8a8": {"layernorm": 2, "quantize": 4, "linear_w8a8": 4, "attention": 1,
             "fused_block_w8a8": 1},
    "int8": {"layernorm": 2, "linear_int8w": 4, "attention": 1,
             "fused_block_int8w": 1},
}
PER_LAYER["auto"] = PER_LAYER["w8a8"]
PER_LAYER["w8a8_outlier"] = PER_LAYER["auto_outlier"] = {
    "layernorm": 2, "quantize_split": 3, "quantize_masked": 1,
    "linear_w8a8_hi": 4, "attention": 1, "fused_block_w8a8_outlier": 1}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        failures.append(what)


def peaks() -> dict:
    name = torch.cuda.get_device_name(0)
    for key, value in PEAKS.items():
        if key in name:
            return value
    return PEAKS["H100"]


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: dict) -> tuple:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peaks ({kind: count})."""
    peak = peaks()
    t_bytes = nbytes / peak["bytes"]
    t_ops = sum(count / peak[kind] for kind, count in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: tuple) -> tuple:
    """(max abs error, within tolerance, share of elements bit-identical to
    the plain version's, mean abs error)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    rtol, atol = tol
    within = bool((diff <= atol + rtol * ref.abs()).all())
    return (float(diff.max()), within, float((diff == 0).float().mean()),
            float(diff.mean()))


def layer_params(gen: torch.Generator, dev, cfg=CFG) -> dict:
    d, h = cfg.embed_dim, cfg.hidden_dim

    def rnd(*shape, std=0.02, mean=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, device=dev) * std + mean
        return t.to(dtype).contiguous()

    return {"ln1_w": rnd(d, mean=1.0, dtype=torch.float32),
            "ln1_b": rnd(d, dtype=torch.float32),
            "qkv_w": rnd(d, 3 * d), "qkv_b": rnd(3 * d, dtype=torch.float32),
            "out_w": rnd(d, d), "out_b": rnd(d, dtype=torch.float32),
            "ln2_w": rnd(d, mean=1.0, dtype=torch.float32),
            "ln2_b": rnd(d, dtype=torch.float32),
            "fc1_w": rnd(d, h), "fc1_b": rnd(h, dtype=torch.float32),
            "fc2_w": rnd(h, d), "fc2_b": rnd(d, dtype=torch.float32)}


def ln_case(name, counter, x, w, b, out_dtype, library, eps=CFG.eps):
    m, d = x.numel() // x.shape[-1], x.shape[-1]
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    return dict(name=name, counter=counter,
                tol=BF16_TOL if out_dtype == torch.bfloat16 else F32_TOL,
                min_same=MIN_SAME_KERNEL if out_dtype == torch.bfloat16 else 0.0,
                kernel=lambda: layernorm.layer_norm(x, w, b, eps, out_dtype=out_dtype),
                plain=lambda: layernorm.layer_norm_reference(x, w, b, eps,
                                                             out_dtype=out_dtype),
                library=library, bytes=m * d * (x.element_size() + out_b) + 2 * d * 4,
                ops={"fp32": 8 * m * d})


def epilogue_ops(y, kw, n, out_dtype):
    """The rest of a GEMM's epilogue as PyTorch ops (library yardsticks)."""
    if kw.get("residual") is not None:
        y = kw["residual"].reshape(-1, n) + y
    if kw.get("fuse_gelu"):
        y = torch.nn.functional.gelu(y, approximate="tanh")
    return y.to(out_dtype)


def kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """Every kernel of the bf16 chain on the chain's own intermediates at
    ``batch`` images: error against the plain version, times, bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev, cfg)
    d, h, t, nh, hd, eps = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                            cfg.num_heads, cfg.head_dim, cfg.eps)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    # The chain's intermediates, from the plain versions.
    h1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = linear.fused_linear_reference(h1, lp["qkv_w"], lp["qkv_b"])
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    x1 = linear.fused_linear_reference(ctx, lp["out_w"], lp["out_b"],
                                       residual=x, out_dtype=f32)
    h2 = layernorm.layer_norm_reference(x1, lp["ln2_w"], lp["ln2_b"], eps,
                                        out_dtype=bf)
    hid = linear.fused_linear_reference(h2, lp["fc1_w"], lp["fc1_b"],
                                        fuse_gelu=True)
    q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    b16 = {key: lp[key].to(bf) for key in ("ln1_w", "ln1_b")}
    F = torch.nn.functional

    def gemm(name, inp, wkey, bkey, n, k_dim, out_dtype, **kw):
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4
        nbytes = m * k_dim * 2 + k_dim * n * 2 + n * 4 + m * n * (res_b + out_b)
        bias = lp[bkey].to(bf)

        def library():
            # cuBLAS with a bias epilogue, then any further epilogue as
            # library ops (no single call fuses a residual or a GELU).
            y = torch.addmm(bias, inp.reshape(m, k_dim), lp[wkey])
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear(inp, lp[wkey], lp[bkey],
                                               out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_reference(inp, lp[wkey], lp[bkey],
                                                        out_dtype=out_dtype, **kw),
            library=library, bytes=nbytes, ops={"bf16": 2 * m * n * k_dim})

    cases = [
        ln_case("layer_norm LN1 (bf16 in, bf16 out)", "layernorm", x,
                lp["ln1_w"], lp["ln1_b"], bf,
                lambda: F.layer_norm(x, (d,), b16["ln1_w"], b16["ln1_b"], eps),
                eps=eps),
        gemm("fused_linear qkv (+bias, bf16 out)", h1, "qkv_w", "qkv_b", 3 * d, d, bf),
        dict(name="packed_fused_attention (bf16)", counter="attention",
             tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
             kernel=lambda: attention.packed_fused_attention(qkv, num_heads=nh,
                                                             head_dim=hd),
             plain=lambda: attention.packed_fused_attention_reference(qkv, nh, hd),
             library=lambda: F.scaled_dot_product_attention(q, k, v),
             bytes=batch * t * 4 * d * 2, ops={"bf16": 4 * batch * nh * t * t * hd}),
        gemm("fused_linear out-proj (+bf16 residual, +bias, fp32 out)", ctx,
             "out_w", "out_b", d, d, f32, residual=x),
        ln_case("layer_norm LN2 (fp32 in, bf16 out)", "layernorm", x1,
                lp["ln2_w"], lp["ln2_b"], bf,
                lambda: F.layer_norm(x1, (d,), lp["ln2_w"], lp["ln2_b"], eps),
                eps=eps),
        gemm("fused_linear fc1 (+bias, _gelu_fast, bf16 out)", h2, "fc1_w", "fc1_b",
             h, d, bf, fuse_gelu=True),
        gemm("fused_linear fc2 (+fp32 residual, +bias, bf16 out)", hid, "fc2_w",
             "fc2_b", d, h, bf, residual=x1),
    ]
    weight_bytes = (4 * d * d + 2 * d * h) * 2 + (9 * d + h) * 4
    cases.append(dict(
        name="fused_encoder_layer (the chain of the 7 launches above)",
        counter="fused_block", tol=BF16_TOL, min_same=MIN_SAME_CHAIN,
        kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg),
        plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg),
        library=None, bytes=2 * m * d * 2 + weight_bytes,
        ops={"bf16": 2 * m * d * (4 * d + 2 * h) + 4 * batch * t * t * d}))
    return run_cases(cases, batch, prefix(cfg))


def int8_kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """The int8 kernels on the W8A8 and weight-only chains' own intermediates
    (from the plain versions) at ``batch`` images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev, cfg)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        lp[key] = quant.quantize_weight_device(lp[key])
    d, h, t, nh, hd = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                       cfg.num_heads, cfg.head_dim)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    F = torch.nn.functional
    eps = cfg.eps

    def w8(key, inp, **kw):
        xq, sx = quant.quantize_act(inp)
        return linear.fused_linear_w8a8_reference(
            xq, sx, lp[key]["q"], lp[key]["scale"], lp[key[:-1] + "b"], **kw)

    # The W8A8 chain's intermediates.
    a1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
    aqkv = w8("qkv_w", a1, out_dtype=bf)
    actx = attention.packed_fused_attention_reference(aqkv, nh, hd)
    ax1 = w8("out_w", actx, residual=x, out_dtype=f32)
    a2 = layernorm.layer_norm_reference(ax1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
    ahid = w8("fc1_w", a2, fuse_gelu=True, out_dtype=f32)
    quantized = {name: quant.quantize_act(inp) for name, inp in
                 (("qkv", a1), ("out", actx), ("fc1", a2), ("fc2", ahid))}

    # The weight-only chain's intermediates.
    def iw(key, inp, **kw):
        return linear.fused_linear_reference(inp, lp[key]["q"], lp[key[:-1] + "b"],
                                             w_scale=lp[key]["scale"], **kw)

    b1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    bctx = attention.packed_fused_attention_reference(iw("qkv_w", b1), nh, hd)
    bx1 = iw("out_w", bctx, residual=x, out_dtype=f32)
    b2 = layernorm.layer_norm_reference(bx1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=bf)
    bhid = iw("fc1_w", b2, fuse_gelu=True)

    def quantize_case(site, inp):
        return dict(
            name=f"quantize_rows {site} ({'bf16' if inp.dtype == bf else 'fp32'} in)",
            counter="quantize", tol=EXACT, min_same=1.0,
            kernel=lambda: quantize.quantize_rows(inp),
            plain=lambda: quantize.quantize_rows_reference(inp), library=None,
            bytes=inp.numel() * (inp.element_size() + 1) + 4 * (inp.numel() // inp.shape[-1]),
            ops={"fp32": 3 * inp.numel()})

    def w8a8_case(name, site, wkey, n, k_dim, out_dtype, **kw):
        xq, sx = quantized[site]
        wq, sw, bias = lp[wkey]["q"], lp[wkey]["scale"], lp[wkey[:-1] + "b"]
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4
        gelu = kw.get("fuse_gelu", False)

        def library():
            acc = torch._int_mm(xq.reshape(m, k_dim), wq)
            y = acc.float() * sx.reshape(m, 1) * sw + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_w8a8",
            tol=F32_TOL if gelu else EXACT, min_same=MIN_SAME_KERNEL if gelu else 1.0,
            kernel=lambda: linear.fused_linear_w8a8(xq, sx, wq, sw, bias,
                                                    out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_w8a8_reference(
                xq, sx, wq, sw, bias, out_dtype=out_dtype, **kw),
            library=library,
            bytes=m * k_dim + k_dim * n + 4 * m + 8 * n + m * n * (res_b + out_b),
            ops={"int8": 2 * m * n * k_dim})

    def int8w_case(name, inp, wkey, n, k_dim, out_dtype, **kw):
        wq, sw, bias = lp[wkey]["q"], lp[wkey]["scale"], lp[wkey[:-1] + "b"]
        w_bf16 = wq.to(bf)
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4

        def library():
            y = torch.mm(inp.reshape(m, k_dim), w_bf16).float() * sw + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_int8w",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear(inp, wq, bias, w_scale=sw,
                                               out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_reference(
                inp, wq, bias, w_scale=sw, out_dtype=out_dtype, **kw),
            library=library,
            bytes=m * k_dim * 2 + k_dim * n + 8 * n + m * n * (res_b + out_b),
            ops={"bf16": 2 * m * n * k_dim})

    weight_bytes = (4 * d * d + 2 * d * h) + (6 * d + 2 * h) * 4 + (9 * d + h) * 4
    attn_ops = 4 * batch * t * t * d
    gemm_ops = 2 * m * d * (4 * d + 2 * h)
    cases = [
        ln_case("layer_norm LN1 (bf16 in, fp32 out; W8A8)", "layernorm", x,
                lp["ln1_w"], lp["ln1_b"], f32,
                lambda: F.layer_norm(x.float(), (d,), lp["ln1_w"], lp["ln1_b"], eps),
                eps=eps),
        ln_case("layer_norm LN2 (fp32 in, fp32 out; W8A8)", "layernorm", ax1,
                lp["ln2_w"], lp["ln2_b"], f32,
                lambda: F.layer_norm(ax1, (d,), lp["ln2_w"], lp["ln2_b"], eps),
                eps=eps),
        quantize_case("LN1 out", a1),
        quantize_case("context", actx),
        quantize_case("LN2 out", a2),
        quantize_case("GELU'd hidden", ahid),
        w8a8_case("fused_linear_w8a8 qkv (+bias, bf16 out)", "qkv", "qkv_w",
                  3 * d, d, bf),
        w8a8_case("fused_linear_w8a8 out-proj (+bf16 residual, +bias, fp32 out)",
                  "out", "out_w", d, d, f32, residual=x),
        w8a8_case("fused_linear_w8a8 fc1 (+bias, _gelu_fast, fp32 out)", "fc1",
                  "fc1_w", h, d, f32, fuse_gelu=True),
        w8a8_case("fused_linear_w8a8 fc2 (+fp32 residual, +bias, bf16 out)", "fc2",
                  "fc2_w", d, h, bf, residual=ax1),
        int8w_case("fused_linear int8 w qkv (+bias, bf16 out)", b1, "qkv_w",
                   3 * d, d, bf),
        int8w_case("fused_linear int8 w out-proj (+bf16 residual, +bias, fp32 out)",
                   bctx, "out_w", d, d, f32, residual=x),
        int8w_case("fused_linear int8 w fc1 (+bias, _gelu_fast, bf16 out)", b2,
                   "fc1_w", h, d, bf, fuse_gelu=True),
        int8w_case("fused_linear int8 w fc2 (+fp32 residual, +bias, bf16 out)",
                   bhid, "fc2_w", d, h, bf, residual=bx1),
        dict(name="fused_encoder_layer W8A8 (the chain of 11 launches)",
             counter="fused_block_w8a8", tol=W8A8_CHAIN_TOL,
             min_same=MIN_SAME_INT8_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg, w8a8=True),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg,
                                                                     w8a8=True),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"int8": gemm_ops, "bf16": attn_ops}),
        dict(name="fused_encoder_layer int8 weights (the chain of 7 launches)",
             counter="fused_block_int8w", tol=BF16_TOL,
             min_same=MIN_SAME_INT8_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"bf16": gemm_ops + attn_ops}),
    ]
    return run_cases(cases, batch, prefix(cfg))


def outlier_kernel_rows(batch: int, dev, params: dict, seed: int = 0) -> list[dict]:
    """The outlier-aware W8A8 kernels on the intermediates (from the plain
    versions) of layer 0 of the calibrated ``params`` at ``batch`` seeded
    images, embedded by the forward's own code."""
    lp = vit._layer(params, 0)
    d, h, nh, hd = CFG.embed_dim, CFG.hidden_dim, CFG.num_heads, CFG.head_dim
    m = batch * CFG.num_tokens
    bf, f32, eps = torch.bfloat16, torch.float32, CFG.eps
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch, 3, CFG.img_size, CFG.img_size), generator=gen,
                         device=dev)
    x = vit.embed(images, params, CFG, bf)
    kh = lp["out_w"]["hi"].shape[0] // nh

    def w8(key, inp_q, **kw):
        q, s, hi = inp_q
        w = lp[key]
        return linear.fused_linear_w8a8_reference(
            q, s, w["q"], w["scale"], lp[key[:-1] + "b"], x_hi=hi,
            w_hi=w["hi"], **kw)

    def split(inp, key):
        return quantize.quantize_rows_split_reference(inp, lp[key]["q"].shape[0], bf)

    # The outlier chain's intermediates.
    a1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
    q1 = split(a1, "qkv_w")
    qkv = w8("qkv_w", q1, out_dtype=bf)
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    qc = quantize.quantize_rows_masked_reference(ctx, nh, hd, kh)
    x1 = w8("out_w", qc, residual=x, out_dtype=f32)
    a2 = layernorm.layer_norm_reference(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
    q2 = split(a2, "fc1_w")
    hid = w8("fc1_w", q2, fuse_gelu=True, out_dtype=f32)
    q3 = split(hid, "fc2_w")
    quantized = {"qkv": q1, "out": qc, "fc1": q2, "fc2": q3}

    def split_case(site, inp, key):
        k, mq = inp.shape[-1], lp[key]["q"].shape[0]
        return dict(
            name=f"quantize_rows_split {site} (fp32 in, int8 [{mq}] + bf16 [{k - mq}] out)",
            counter="quantize_split", tol=EXACT, min_same=1.0,
            kernel=lambda: quantize.quantize_rows_split(inp, mq, bf),
            plain=lambda: quantize.quantize_rows_split_reference(inp, mq, bf),
            library=None, bytes=m * k * 4 + m * mq + m * (k - mq) * 2 + 4 * m,
            ops={"fp32": 3 * m * mq})

    def side_case(name, site, wkey, n, out_dtype, **kw):
        xq, sx, x_hi = quantized[site]
        k_dim, k_hi = xq.shape[-1], x_hi.shape[-1]
        w, bias = lp[wkey], lp[wkey[:-1] + "b"]
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4

        def library():
            acc = torch._int_mm(xq.reshape(m, k_dim), w["q"])
            side = torch.mm(x_hi.reshape(m, k_hi), w["hi"])
            y = acc.float() * sx.reshape(m, 1) * w["scale"] + side.float() + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_w8a8_hi",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear_w8a8(
                xq, sx, w["q"], w["scale"], bias, x_hi=x_hi, w_hi=w["hi"],
                out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_w8a8_reference(
                xq, sx, w["q"], w["scale"], bias, x_hi=x_hi, w_hi=w["hi"],
                out_dtype=out_dtype, **kw),
            library=library,
            bytes=(m * k_dim + k_dim * n + 4 * m + 8 * n + (m * k_hi + k_hi * n) * 2
                   + m * n * (res_b + out_b)),
            ops={"int8": 2 * m * n * k_dim, "bf16": 2 * m * n * k_hi})

    # int8 and bf16 weight elements of the layer; scales, biases and LN
    # parameters in fp32.
    k_d, k_h = d - lp["qkv_w"]["q"].shape[0], h - lp["fc2_w"]["q"].shape[0]
    int8_w = (d - k_d) * (3 * d + h) + d * d + (h - k_h) * d
    bf16_w = k_d * (3 * d + h) + nh * kh * d + k_h * d
    weight_bytes = int8_w + 2 * bf16_w + (5 * d + h) * 4 + (9 * d + h) * 4
    cases = [
        split_case("LN1 out", a1, "qkv_w"),
        dict(name=f"quantize_rows_masked context (bf16 in, {nh} x {kh} tails out)",
             counter="quantize_masked", tol=EXACT, min_same=1.0,
             kernel=lambda: quantize.quantize_rows_masked(ctx, nh, hd, kh),
             plain=lambda: quantize.quantize_rows_masked_reference(ctx, nh, hd, kh),
             library=None, bytes=m * d * 3 + m * nh * kh * 2 + 4 * m,
             ops={"fp32": 3 * m * d}),
        split_case("LN2 out", a2, "fc1_w"),
        split_case("GELU'd hidden", hid, "fc2_w"),
        side_case("fused_linear_w8a8 + bf16 side qkv (+bias, bf16 out)", "qkv",
                  "qkv_w", 3 * d, bf),
        side_case("fused_linear_w8a8 + bf16 side out-proj (+bf16 residual, +bias, "
                  "fp32 out)", "out", "out_w", d, f32, residual=x),
        side_case("fused_linear_w8a8 + bf16 side fc1 (+bias, _gelu_fast, fp32 out)",
                  "fc1", "fc1_w", h, f32, fuse_gelu=True),
        side_case("fused_linear_w8a8 + bf16 side fc2 (+fp32 residual, +bias, bf16 out)",
                  "fc2", "fc2_w", d, bf, residual=x1),
        dict(name="fused_encoder_layer outlier-aware W8A8 (the chain of 11 launches)",
             counter="fused_block_w8a8_outlier", tol=OUTLIER_CHAIN_TOL,
             min_same=MIN_SAME_OUTLIER_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG, w8a8=True),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG,
                                                                     w8a8=True),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"int8": 2 * m * int8_w,
                  "bf16": 2 * m * bf16_w + 4 * batch * CFG.num_tokens ** 2 * d}),
    ]
    return run_cases(cases, batch)


@functools.lru_cache(maxsize=None)
def small_params(cfg, dev) -> tuple:
    """Seeded stacked bf16 weights of ``cfg`` on the card and their int8
    form (host quantization, as the engine's), made once per config."""
    params = vit.stack_params(fixtures.random_params(cfg, seed=3), cfg, device=dev)
    return params, quant.quantize_stacked_params(params, cfg)


def stack_ops(cfg, batch: int, depth: int) -> int:
    """Multiply-add operations (x2) of ``depth`` layers at ``batch`` images."""
    d, h, t = cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens
    return depth * (2 * batch * t * d * (4 * d + 2 * h) + 4 * batch * t * t * d)


def stack_weight_bytes(cfg, depth: int, wbytes: int) -> int:
    d, h = cfg.embed_dim, cfg.hidden_dim
    scales = (6 * d + 2 * h) * 4 if wbytes == 1 else 0
    return depth * ((4 * d * d + 2 * d * h) * wbytes + scales + (9 * d + h) * 4)


def stack_kernel_rows(cfg, batch: int, dev, seed: int = 0) -> tuple:
    """Phase 2d for ``cfg`` at ``batch`` images: every kernel of its chains
    at their shapes (``kernel_rows``, ``int8_kernel_rows``); then the stacks
    of ``cfg`` (the W8A8 stack and the layer group at REDUCED_DEPTH) and the
    stack at one layer against their plain versions, with the per-layer
    chain over every layer beside them. Returns the three lists of rows."""
    kernels = kernel_rows(batch, dev, seed, cfg)
    int8_kernels = int8_kernel_rows(batch, dev, seed, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, t, m = cfg.embed_dim, cfg.num_tokens, batch * cfg.num_tokens
    params, params8 = small_params(cfg, dev)
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(torch.bfloat16)

    def per_layer(fn, layers=None, conf=cfg, **kw):
        """The per-layer chain over every layer of ``conf`` (kernels or
        plain)."""
        stacked = params if layers is None else {"layers": layers}

        def run():
            y = x
            for layer in range(conf.depth):
                y = fn(y, vit._layer(stacked, layer), conf, **kw)
            return y
        return run

    def stack(name, counter, layers, tol, min_same, wbytes, depth=cfg.depth,
              ops_kind="bf16", w8a8=False, **kw):
        conf = dataclasses.replace(cfg, depth=depth)
        fn = fused_block.fused_encoder_stack
        ref = fused_block.fused_encoder_stack_reference
        if "group_size" in kw:
            fn = fused_block.fused_encoder_group
            ref = fused_block.fused_encoder_group_reference
        ops = stack_ops(cfg, batch, depth)
        attn = depth * 4 * batch * t * t * d
        # The fault the stack exists to avoid: the stream rounded to the
        # activation dtype at every layer (the plain per-layer chain).
        fault = max_err(per_layer(fused_block.fused_encoder_layer_reference, layers,
                                  conf, w8a8=w8a8)(),
                        ref(x, layers, conf, w8a8=w8a8, **kw), tol)
        print(f"  B={batch} {cfg.name} {name}: the plain per-layer chain (stream "
              f"rounded at each layer) vs the plain version: max_abs_err "
              f"{fault[0]:.3e}, mean {fault[3]:.3e}, {fault[2]:.2%} bit-identical",
              flush=True)
        return dict(
            name=name, counter=counter, tol=tol, min_same=min_same,
            max_mean=float("inf") if w8a8 else STACK_FAULT_SHARE * fault[3],
            kernel=lambda: fn(x, layers, conf, w8a8=w8a8, **kw),
            plain=lambda: ref(x, layers, conf, w8a8=w8a8, **kw),
            library=None,
            bytes=2 * m * d * 2 + stack_weight_bytes(cfg, depth, wbytes),
            ops={"bf16": ops} if ops_kind == "bf16" else {"int8": ops - attn, "bf16": attn})

    def first(layers, depth):
        return {k: ({kk: vv[:depth] for kk, vv in v.items()} if isinstance(v, dict)
                    else v[:depth]) for k, v in layers.items()}

    L, r = cfg.depth, REDUCED_DEPTH
    lp0 = vit._layer(params, 0)
    cases = [
        stack(f"fused_encoder_stack bf16 ({L} layers, {7 * L} launches)",
              "fused_block_stack", params["layers"], BF16_TOL, MIN_SAME_STACK, 2),
        stack(f"fused_encoder_stack int8 weights ({L} layers, {7 * L} launches)",
              "fused_block_stack_int8w", params8["layers"], BF16_TOL,
              MIN_SAME_STACK, 1),
        dict(name="fused_encoder_layer_flat bf16 (the stack at one layer, 7 "
                  "launches)", counter="stack_flat", tol=BF16_TOL,
             min_same=MIN_SAME_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer_flat(x, lp0, cfg),
             plain=lambda: fused_block.fused_encoder_stack_reference(
                 x, first(params["layers"], 1), cfg, num_layers=1),
             library=None, bytes=2 * m * d * 2 + stack_weight_bytes(cfg, 1, 2),
             ops={"bf16": stack_ops(cfg, batch, 1)}),
        dict(name=f"fused_encoder_layer bf16 x {L} (the per-layer chain over "
                  f"every layer, {7 * L} launches; for comparison)",
             counter="per_layer_chain", tol=BF16_TOL, min_same=0.0, gate=False,
             kernel=per_layer(fused_block.fused_encoder_layer),
             plain=per_layer(fused_block.fused_encoder_layer_reference),
             library=None, bytes=2 * m * d * 2 + stack_weight_bytes(cfg, L, 2),
             ops={"bf16": stack_ops(cfg, batch, L)}),
        stack(f"fused_encoder_stack W8A8 ({r} layers, {11 * r} launches)",
              "fused_block_stack_w8a8", first(params8["layers"], r), STACK_W8A8_TOL,
              MIN_SAME_STACK_W8A8, 1, depth=r, ops_kind="int8", w8a8=True),
        stack(f"fused_encoder_group bf16 (2 groups of 2 layers, {7 * r} launches)",
              "fused_block_group", first(params["layers"], r), BF16_TOL,
              MIN_SAME_STACK, 2, depth=r, group_size=2),
    ]
    return kernels, int8_kernels, run_cases(cases, batch, prefix(cfg))


def _outputs(value) -> list:
    return list(value) if isinstance(value, tuple) else [value]


def prefix(cfg) -> str:
    """Row names of the small configs start with the config's name."""
    return "" if cfg is CFG else f"{cfg.name} "


def run_cases(cases: list[dict], batch: int, name_prefix: str = "") -> list[dict]:
    """Each case against its plain version, then timed. A case with several
    outputs may give each its own tolerance and share (lists); a case with
    ``gate=False`` is printed for comparison and not checked."""
    rows = []
    for case in cases:
        case = dict(case, name=name_prefix + case["name"])
        outs, refs = _outputs(case["kernel"]()), _outputs(case["plain"]())
        torch.cuda.synchronize()
        tols = case["tol"] if isinstance(case["tol"], list) else [case["tol"]] * len(outs)
        mins = (case["min_same"] if isinstance(case["min_same"], list)
                else [case["min_same"]] * len(outs))
        errs = [max_err(o, r, tol) for o, r, tol in zip(outs, refs, tols)]
        if len(outs) > 1:
            for i, (e, tol) in enumerate(zip(errs, tols)):
                print(f"  B={batch} {case['name']} output {i} ({outs[i].dtype}): "
                      f"max_abs_err {e[0]:.3e} (tol rtol {tol[0]} atol {tol[1]}), "
                      f"{e[2]:.2%} bit-identical", flush=True)
        err = max(e[0] for e in errs)
        within = all(e[1] for e in errs)
        same = min(e[2] for e in errs)
        mean_err = max(e[3] for e in errs)
        share_ok = all(e[2] >= low for e, low in zip(errs, mins))
        max_mean = case.get("max_mean", float("inf"))
        scale = max(float(r.float().abs().max()) for r in refs)
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        library_ms = None
        if case["library"] is not None:
            try:
                library_ms = time_ms(case["library"])
            except RuntimeError as exc:  # e.g. _int_mm refusing a shape
                print(f"  library call refused: {str(exc).splitlines()[0]}")
        row = dict(name=case["name"], counter=case["counter"], max_abs_err=err,
                   mean_abs_err=mean_err, tol=tols[0], within=within, same=same,
                   ms=time_ms(case["kernel"]),
                   plain_ms=time_ms(case["plain"], reps=PLAIN_REPS),
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        print(f"  B={batch} {row['name']}: max_abs_err {err:.3e} "
              f"(mean {mean_err:.3e}; |plain| up to {scale:.3g}; "
              f"tol rtol {row['tol'][0]} atol {row['tol'][1]}; "
              f"{same:.2%} bit-identical) "
              f"{row['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"plain {row['plain_ms']:.4f} ms, library {lib} ms", flush=True)
        if case.get("gate", True):
            check(within and share_ok and mean_err <= max_mean,
                  f"B={batch} {row['name']} within tolerance of its plain version, "
                  f"bit-identical share {same:.4f} >= {min(mins)}, mean abs error "
                  f"{mean_err:.3e} <= {max_mean:.3e}")
    return rows


def fp32_layer_norm_check(dev) -> None:
    """The LN kernel is the one link with an fp32 variant: hold it tightly."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((SMOKE_BATCH * CFG.num_tokens, CFG.embed_dim), generator=gen,
                    device=dev) * 2
    w = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1 + 1
    b = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1
    err, within, *_ = max_err(layernorm.layer_norm(x, w, b, CFG.eps),
                             layernorm.layer_norm_reference(x, w, b, CFG.eps), F32_TOL)
    check(within, f"layer_norm fp32 in/out: max_abs_err {err:.3e} "
                  f"(tol rtol {F32_TOL[0]} atol {F32_TOL[1]})")


def read_counts() -> dict:
    return {key: getattr(mod, attr) for key, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def fp32_logits(params: dict, images: np.ndarray, dev, cfg=CFG) -> torch.Tensor:
    stacked = vit.stack_params(params, cfg, param_dtype=torch.float32, device=dev)
    out = []
    for start in range(0, len(images), SMOKE_BATCH):
        batch = torch.from_numpy(images[start:start + SMOKE_BATCH]).to(dev)
        out.append(vit.forward(batch, stacked, cfg, compute_dtype=torch.float32,
                               return_logits=True))
    return torch.cat(out)


def decisive_images(params: dict, dev, cfg=CFG) -> np.ndarray:
    """40 seeded images on which the fp32 plain model's top-2 logits are at
    least MIN_LOGIT_GAP apart, drawn in order from a seeded pool."""
    pool = fixtures.random_images(cfg, n=4 * N_IMAGES, seed=1)
    top2 = fp32_logits(params, pool, dev, cfg).topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    keep = np.flatnonzero(gaps >= MIN_LOGIT_GAP)[:N_IMAGES]
    print(f"  {cfg.name}: {int((gaps >= MIN_LOGIT_GAP).sum())} of {len(pool)} pool "
          f"images have a top-2 logit gap >= {MIN_LOGIT_GAP} (median gap "
          f"{float(np.median(gaps)):.4f})", flush=True)
    if len(keep) < N_IMAGES:
        raise RuntimeError(f"only {len(keep)} decisive images in the pool")
    return pool[keep]


@contextlib.contextmanager
def plain_chain(name: str = "fused_encoder_layer"):
    """The engine's encoder through the plain versions of the chain
    ``fused_block.<name>`` (the per-layer chain, or the stack)."""
    kernel_version = getattr(fused_block, name)
    setattr(fused_block, name, getattr(fused_block, name + "_reference"))
    try:
        yield
    finally:
        setattr(fused_block, name, kernel_version)


@contextlib.contextmanager
def per_layer_chain():
    """The stack-class configs routed to the per-layer chain instead, for
    comparison (int8 weights ignore a forced ``encoder_block``, so the route
    is switched where ``models/vit.encoder`` chooses it)."""
    kernel_version = fused_block.supports_stack
    fused_block.supports_stack = lambda *_args, **_kw: False
    try:
        yield
    finally:
        fused_block.supports_stack = kernel_version


def adversarial_weights() -> dict:
    """Phase 3c's weights: seeded adversarial ViT-B/16 weights with the
    classifier head scaled by HEAD_SCALE."""
    params = fixtures.adversarial_params(CFG, seed=0)
    params["heads_head_weight"] = params["heads_head_weight"] * HEAD_SCALE
    return params


def make_workspace(ws: Path, dev, params: dict, cfg=CFG) -> tuple:
    """Weights, decisive images and the fp32 answer file in ``ws``, and a
    seeded calibration binary."""
    t0 = time.perf_counter()
    ws.mkdir(parents=True, exist_ok=True)
    binfmt.save_weights(ws / "Network", fixtures.params_to_positional(params, cfg),
                        cfg)
    binfmt.save_image_data(ws / "calib.bin",
                           fixtures.random_images(cfg, n=N_CALIB, seed=99))
    # The answer: the weights as the loader sees them (6-decimal rounded),
    # through the port's plain fp32 path on the card.
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    with torch.inference_mode():
        images = decisive_images(rounded, dev, cfg)
    binfmt.save_image_data(ws / "input.bin", images)
    ref_engine = InferenceEngine(cfg, rounded, batch_size=SMOKE_BATCH,
                                 param_dtype=torch.float32,
                                 compute_dtype=torch.float32,
                                 attention_impl="xla", device=dev)
    ref_probs = ref_engine.run(images)
    del ref_engine
    results.write_results(ws / "answer.txt", ref_probs)
    print(f"  workspace: {cfg.name} weights, {N_IMAGES} images, fp32 answer "
          f"file in {time.perf_counter() - t0:.1f} s", flush=True)
    return rounded, images, ref_probs


def run_cli(ws: Path, mode: str, ref_probs: np.ndarray, cfg=CFG,
            per_forward: dict | None = None) -> tuple:
    """One main-path run through the CLI: the counts of exactly this run, and
    the max abs error of its result file's probabilities. The expected
    counts are ``per_forward`` launches for each of the run's forwards, by
    default PER_LAYER[mode] for each layer."""
    flags = list(MODES[mode])
    if mode.endswith("_outlier"):
        flags += ["--calibrate", str(ws / "calib.bin")]
    argv = ["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
            "--output", str(ws / f"result_{mode}.txt"),
            "--answer", str(ws / "answer.txt"), "--backend", "gpu",
            "--attention", "flash", "--config", cfg.name,
            "--batch-size", str(SMOKE_BATCH), *flags]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    print("  " + out.getvalue().strip().replace("\n", "\n  "))
    check(rc == 0 and "Comparator: files match." in out.getvalue(),
          f"cli --config {cfg.name} --backend gpu --attention flash "
          f"{' '.join(flags)}: rc {rc}, comparator green")
    batches = -(-N_IMAGES // SMOKE_BATCH)
    if per_forward is None:
        per_forward = {key: n * cfg.depth for key, n in PER_LAYER[mode].items()}
    expected = {key: per_forward.get(key, 0) * batches for key in COUNTERS}
    check(counts == expected, f"launches on the {cfg.name} {mode} main path "
                              f"{counts}, expected {expected}")
    lines = [results.parse_result_line(line) for line in
             (ws / f"result_{mode}.txt").read_text().splitlines()]
    file_err = max(abs(p - float(ref_probs[i].max())) for i, (_, p) in
                   enumerate(lines))
    print(f"  {cfg.name} {mode}: result-file probabilities vs the fp32 answer: max abs "
          f"err {file_err:.3e}", flush=True)
    return counts, file_err


def main_path(ws: Path, dev, rounded, images, ref_probs) -> tuple:
    counts, file_err = run_cli(ws, "bf16", ref_probs)
    engine = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                             attention_impl="flash", device=dev)
    probs = engine.run(images)
    prob_err = float(np.abs(probs - ref_probs).max())
    check(prob_err <= PROB_TOL and file_err <= PROB_TOL,
          f"bf16 flash probabilities vs fp32 plain: max abs err {prob_err:.3e} "
          f"(result file {file_err:.3e}), budget {PROB_TOL}")
    return counts, engine


def int8_main_path(ws: Path, dev, rounded, images, ref_probs) -> tuple:
    # "auto" must resolve to W8A8 on ViT-B: its run's launch counts are the
    # W8A8 chain's (PER_LAYER).
    counts = {mode: run_cli(ws, mode, ref_probs)[0]
              for mode in ("w8a8", "int8", "auto")}
    engines = {mode: InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                     attention_impl="flash", device=dev,
                                     quantize=flag)
               for mode, flag in (("w8a8", "int8-w8a8"), ("int8", "int8"))}
    w8a8 = engines["w8a8"]
    probs = w8a8.run(images)
    with plain_chain():
        plain_probs = w8a8.run(images)
    err = float(np.abs(probs - plain_probs).max())
    check(err <= PROB_TOL, f"W8A8 flash probabilities vs the plain W8A8 chain: "
                           f"max abs err {err:.3e}, budget {PROB_TOL}")
    # What the int8 modes move against fp32, in logits: the basis of
    # MIN_LOGIT_GAP.
    with torch.inference_mode():
        log_int8_logit_errors(engines, rounded, images, ref_probs, dev)
    return counts, engines


def outlier_main_path(ws: Path, dev, rounded, images, ref_probs,
                      engine: InferenceEngine) -> dict:
    """Phase 3c. ``engine`` is the calibrated W8A8 engine of phase 2c, built
    from the same weights and calibration images as the CLI runs."""
    counts = {mode: run_cli(ws, mode, ref_probs)[0]
              for mode in ("w8a8_outlier", "auto_outlier")}
    probs = engine.run(images)
    with plain_chain():
        plain_probs = engine.run(images)
    err = float(np.abs(probs - plain_probs).max())
    check(err <= PROB_TOL, f"calibrated W8A8 flash probabilities vs its plain "
                           f"chain: max abs err {err:.3e}, budget {PROB_TOL}")
    print(f"  calibrated W8A8 vs the fp32 answer: max abs err "
          f"{float(np.abs(probs - ref_probs).max()):.3e} (kernels), "
          f"{float(np.abs(plain_probs - ref_probs).max()):.3e} (plain chain); "
          f"the comparator's bound is 0.01", flush=True)
    # What the calibration fixes (printed, not gated): plain per-token W8A8
    # on the same weights.
    uncalibrated = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                   attention_impl="flash", device=dev,
                                   quantize="int8-w8a8")
    with torch.inference_mode():
        log_int8_logit_errors({"w8a8_outlier": engine,
                               "w8a8 uncalibrated": uncalibrated},
                              rounded, images, ref_probs, dev)
    return counts


def stack_per_forward(cfg, mode: str) -> dict:
    """Launches of one forward through the stack: per layer LN1, qkv,
    attention, out-proj, LN2, fc1 and fc2, and one stack call."""
    depth = cfg.depth
    suffix = "_int8w" if mode == "int8" else ""
    return {"layernorm": 2 * depth, "attention": depth,
            ("linear_int8w" if mode == "int8" else "linear"): 4 * depth,
            "fused_block_stack" + suffix: 1}


def small_main_path(ws: Path, dev, cfg) -> tuple:
    """Phase 3d for one stack-class config: the CLI runs and their counts,
    and the bf16 and int8-weight engines held to their plain stacks."""
    rounded, images, ref_probs = make_workspace(
        ws, dev, fixtures.random_params(cfg, seed=0), cfg)
    counts = {mode: run_cli(ws, mode, ref_probs, cfg, stack_per_forward(cfg, mode))[0]
              for mode in ("bf16", "auto", "int8")}
    forwards = -(-N_IMAGES // SMOKE_BATCH)
    check(counts["bf16"]["fused_block_stack"] == forwards
          and counts["int8"]["fused_block_stack_int8w"] == forwards
          and not any(c["fused_block"] or c["fused_block_int8w"] for c in counts.values()),
          f"{cfg.name}: one stack call per forward ({forwards}), no per-layer chain")
    if cfg.name == VIT_S_16_224.name:
        # W8A8 stays per-layer on the stack-class configs, as in JAX.
        counts["w8a8"] = run_cli(ws, "w8a8", ref_probs, cfg)[0]
    engines = {mode: InferenceEngine(cfg, rounded, batch_size=SMOKE_BATCH,
                                     attention_impl="flash", device=dev,
                                     quantize=flag)
               for mode, flag in (("bf16", None), ("int8", "int8"))}
    for mode, engine in engines.items():
        probs = engine.run(images)
        with plain_chain("fused_encoder_stack"):
            plain_probs = engine.run(images)
        err = float(np.abs(probs - plain_probs).max())
        check(err <= PROB_TOL, f"{cfg.name} {mode} stack probabilities vs the plain "
                               f"stack: max abs err {err:.3e}, budget {PROB_TOL}")
        print(f"  {cfg.name} {mode}: probabilities vs the fp32 answer: max abs err "
              f"{float(np.abs(probs - ref_probs).max()):.3e} (kernels), "
              f"{float(np.abs(plain_probs - ref_probs).max()):.3e} (plain stack)",
              flush=True)
    return counts, engines


def small_throughput(cfg, engines: dict, dev) -> None:
    """Phase 4 for one stack-class config: img/s of the stack engines beside
    the same engines on the per-layer chain; the stack rows at B = 256."""
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, cfg.img_size, cfg.img_size),
                             generator=gen, device=dev)
        if batch == THROUGHPUT_BATCHES[-1]:
            stack_kernel_rows(cfg, batch, dev, seed=batch)
        for mode, engine in engines.items():
            ms = time_ms(lambda: engine.forward(images), reps=10)
            with per_layer_chain():
                ms_layer = time_ms(lambda: engine.forward(images), reps=10)
            print(f"throughput {cfg.name} {mode} B={batch}: stack {batch / ms * 1e3:.1f} "
                  f"img/s ({ms:.3f} ms per forward); per-layer chain "
                  f"{batch / ms_layer * 1e3:.1f} img/s ({ms_layer:.3f} ms); "
                  f"stack/chain {ms_layer / ms:.3f}x", flush=True)
            print(json.dumps({"throughput": {
                "config": cfg.name, "mode": mode, "batch": batch,
                "img_per_s": batch / ms * 1e3, "forward_ms": ms,
                "per_layer_img_per_s": batch / ms_layer * 1e3,
                "per_layer_forward_ms": ms_layer}}), flush=True)


def log_int8_logit_errors(engines, rounded, images, ref_probs, dev) -> None:
    ref_logits = fp32_logits(rounded, images, dev)
    top2 = ref_logits.topk(2, dim=-1).values
    for mode, engine in engines.items():
        logits = torch.cat([
            vit.forward(torch.from_numpy(images[s:s + SMOKE_BATCH]).to(dev),
                        engine.params, CFG, kernels=engine.kernels,
                        return_logits=True)
            for s in range(0, N_IMAGES, SMOKE_BATCH)])
        flips = int((logits.argmax(-1) != ref_logits.argmax(-1)).sum())
        print(f"  {mode}: logits vs fp32 max abs err "
              f"{float((logits - ref_logits).abs().max()):.4e}; probabilities "
              f"vs the fp32 answer {float(np.abs(engine.run(images) - ref_probs).max()):.3e}; "
              f"top-1 flips {flips} of {N_IMAGES}; smallest fp32 top-2 gap "
              f"{float((top2[:, 0] - top2[:, 1]).min()):.4f}", flush=True)


def throughput(engines: dict, dev) -> None:
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, CFG.img_size, CFG.img_size),
                             generator=gen, device=dev)
        rows = kernel_rows(batch, dev, seed=batch)
        int8_rows = int8_kernel_rows(batch, dev, seed=batch)
        outlier_rows = outlier_kernel_rows(batch, dev,
                                           engines["w8a8_outlier"].params,
                                           seed=batch)
        attn = [r for r in rows if r["counter"] == "attention"]
        w8a8_ln = [r for r in int8_rows if r["counter"] == "layernorm"]
        layer_rows = {
            "bf16": [r for r in rows if r["counter"] != "fused_block"],
            "w8a8": attn + [r for r in int8_rows if r["counter"] in
                            ("layernorm", "quantize", "linear_w8a8")],
            "int8": [r for r in rows if r["counter"] in ("layernorm", "attention")]
                    + [r for r in int8_rows if r["counter"] == "linear_int8w"],
            "w8a8_outlier": attn + w8a8_ln + outlier_rows[:-1],
        }
        chains = {"bf16": rows[-1], "w8a8": int8_rows[-2], "int8": int8_rows[-1],
                  "w8a8_outlier": outlier_rows[-1]}
        for mode, engine in engines.items():
            engine.forward(images)  # warm-up
            ms = time_ms(lambda: engine.forward(images), reps=10)
            per_layer = sum(r["ms"] for r in layer_rows[mode])
            bound_layer = sum(r["bound_ms"] for r in layer_rows[mode])
            print(f"throughput {mode} B={batch}: {batch / ms * 1e3:.1f} img/s "
                  f"({ms:.3f} ms per forward); kernels {CFG.depth} x "
                  f"{per_layer:.3f} ms = {CFG.depth * per_layer:.3f} ms; chain "
                  f"{CFG.depth} x {chains[mode]['ms']:.3f} ms; kernel bounds "
                  f"{CFG.depth} x {bound_layer:.3f} ms = "
                  f"{CFG.depth * bound_layer:.3f} ms", flush=True)
            print(json.dumps({"throughput": {
                "mode": mode, "batch": batch, "img_per_s": batch / ms * 1e3,
                "forward_ms": ms,
                "kernels": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by", "max_abs_err", "same")}
                            for r in layer_rows[mode] + [chains[mode]]]}}),
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke needs a card")
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== phase 1: device and build", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, peaks {peaks()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    with torch.inference_mode():
        print(f"== phase 2: kernels vs plain versions, B={SMOKE_BATCH}", flush=True)
        rows = kernel_rows(SMOKE_BATCH, dev)
        fp32_layer_norm_check(dev)
        print(f"== phase 2b: int8 kernels vs plain versions, B={SMOKE_BATCH}",
              flush=True)
        int8_rows = int8_kernel_rows(SMOKE_BATCH, dev)
        print(f"== phase 2d: the whole-encoder stack of ViT-Ti/16 and ViT-S/16 vs "
              f"plain versions, B={SMOKE_BATCH}", flush=True)
        small_rows = {cfg.name: stack_kernel_rows(cfg, SMOKE_BATCH, dev)
                      for cfg in SMALL_CFGS}

    with tempfile.TemporaryDirectory() as tmp:
        print(f"== phase 2c: outlier-aware W8A8 kernels vs plain versions, "
              f"B={SMOKE_BATCH}", flush=True)
        t0 = time.perf_counter()
        adv_ws = Path(tmp) / "adversarial"
        adv_rounded, adv_images, adv_ref = make_workspace(adv_ws, dev,
                                                          adversarial_weights())
        outlier_engine = InferenceEngine(
            CFG, adv_rounded, batch_size=SMOKE_BATCH, attention_impl="flash",
            device=dev, quantize="int8-w8a8",
            calibrate=binfmt.load_image_data(adv_ws / "calib.bin"))
        print(f"  calibrated W8A8 engine set up in {outlier_engine.setup_time:.1f} s "
              f"(workspace and engine {time.perf_counter() - t0:.1f} s)", flush=True)
        with torch.inference_mode():
            outlier_rows = outlier_kernel_rows(SMOKE_BATCH, dev,
                                               outlier_engine.params)

        ws = Path(tmp) / "random"
        print("== phase 3: main path (cli, ViT-B/16, bf16, flash)", flush=True)
        rounded, images, ref_probs = make_workspace(
            ws, dev, fixtures.random_params(CFG, seed=0))
        counts, engine = main_path(ws, dev, rounded, images, ref_probs)
        print("== phase 3b: int8 main path (cli --quantize int8-w8a8, int8, auto)",
              flush=True)
        int8_counts, engines = int8_main_path(ws, dev, rounded, images, ref_probs)
        print("== phase 3c: calibrated outlier-aware W8A8 main path (cli "
              "--quantize int8-w8a8|auto --calibrate)", flush=True)
        outlier_counts = outlier_main_path(adv_ws, dev, adv_rounded, adv_images,
                                           adv_ref, outlier_engine)
        print("== phase 3d: the stack's main path (cli --config vit_tiny_16_224|"
              "vit_s_16_224, no flags, --quantize auto, int8; int8-w8a8 on ViT-S)",
              flush=True)
        small = {cfg.name: small_main_path(Path(tmp) / cfg.name, dev, cfg)
                 for cfg in SMALL_CFGS}

    print("== phase 4: throughput", flush=True)
    with torch.inference_mode():
        throughput({"bf16": engine, **engines, "w8a8_outlier": outlier_engine}, dev)
        for cfg in SMALL_CFGS:
            small_throughput(cfg, small[cfg.name][1], dev)

    # Each row's launches: from the main-path run that drives its kernel.
    runs = [(counts, r) for r in rows] + [
        (int8_counts["int8" if r["counter"].endswith("int8w") else "w8a8"], r)
        for r in int8_rows] + [(outlier_counts["w8a8_outlier"], r)
                               for r in outlier_rows]
    # The small configs' rows, from the CLI run of their config that drives
    # them (bf16, int8 weights, and W8A8 on ViT-S); rows of chains that no
    # small-config run drives (the per-layer bf16 and int8-weight chains,
    # W8A8 on ViT-Ti, the W8A8 stack and the group, as in the JAX package)
    # are printed above, not recorded.
    def int8w(r):
        return r["counter"].endswith("int8w")

    for name, (kernels_, int8_kernels_, stacks_) in small_rows.items():
        cli = small[name][0]
        pairs = ([(cli["bf16"], r) for r in kernels_]
                 + [(cli["int8"] if int8w(r) else cli.get("w8a8"), r)
                    for r in int8_kernels_]
                 + [(cli["int8"] if int8w(r) else cli["bf16"], r) for r in stacks_])
        runs += [(run, r) for run, r in pairs
                 if run and r["counter"] in SOURCES and run[r["counter"]]]
    record = {"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["counter"]],
         "replaces": REPLACES[r["counter"]], "launches": run[r["counter"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for run, r in runs]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print(f"FAILED: {len(failures)} check(s): {failures}")
        return 1
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
4. Throughput of the full-depth bf16, W8A8, int8 and calibrated W8A8 flash
   forwards at batch 64 and 256, beside the sums of their kernels' times and
   bounds at the same batch.

Counts are set to 0 just before each main-path run and read just after.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
    the plain version's)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    rtol, atol = tol
    within = bool((diff <= atol + rtol * ref.abs()).all())
    return float(diff.max()), within, float((diff == 0).float().mean())


def layer_params(gen: torch.Generator, dev) -> dict:
    d, h = CFG.embed_dim, CFG.hidden_dim

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


def ln_case(name, counter, x, w, b, out_dtype, library):
    m, d = x.numel() // x.shape[-1], x.shape[-1]
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    return dict(name=name, counter=counter,
                tol=BF16_TOL if out_dtype == torch.bfloat16 else F32_TOL,
                min_same=MIN_SAME_KERNEL if out_dtype == torch.bfloat16 else 0.0,
                kernel=lambda: layernorm.layer_norm(x, w, b, CFG.eps, out_dtype=out_dtype),
                plain=lambda: layernorm.layer_norm_reference(x, w, b, CFG.eps,
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


def kernel_rows(batch: int, dev, seed: int = 0) -> list[dict]:
    """Every kernel of the bf16 chain on the chain's own intermediates at
    ``batch`` images: error against the plain version, times, bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev)
    d, h, t, nh, hd = (CFG.embed_dim, CFG.hidden_dim, CFG.num_tokens,
                       CFG.num_heads, CFG.head_dim)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    # The chain's intermediates, from the plain versions.
    h1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], CFG.eps)
    qkv = linear.fused_linear_reference(h1, lp["qkv_w"], lp["qkv_b"])
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    x1 = linear.fused_linear_reference(ctx, lp["out_w"], lp["out_b"],
                                       residual=x, out_dtype=f32)
    h2 = layernorm.layer_norm_reference(x1, lp["ln2_w"], lp["ln2_b"], CFG.eps,
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
                lambda: F.layer_norm(x, (d,), b16["ln1_w"], b16["ln1_b"], CFG.eps)),
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
                lambda: F.layer_norm(x1, (d,), lp["ln2_w"], lp["ln2_b"], CFG.eps)),
        gemm("fused_linear fc1 (+bias, _gelu_fast, bf16 out)", h2, "fc1_w", "fc1_b",
             h, d, bf, fuse_gelu=True),
        gemm("fused_linear fc2 (+fp32 residual, +bias, bf16 out)", hid, "fc2_w",
             "fc2_b", d, h, bf, residual=x1),
    ]
    weight_bytes = (4 * d * d + 2 * d * h) * 2 + (9 * d + h) * 4
    cases.append(dict(
        name="fused_encoder_layer (the chain of the 7 launches above)",
        counter="fused_block", tol=BF16_TOL, min_same=MIN_SAME_CHAIN,
        kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG),
        plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG),
        library=None, bytes=2 * m * d * 2 + weight_bytes,
        ops={"bf16": 2 * m * d * (4 * d + 2 * h) + 4 * batch * t * t * d}))
    return run_cases(cases, batch)


def int8_kernel_rows(batch: int, dev, seed: int = 0) -> list[dict]:
    """The int8 kernels on the W8A8 and weight-only chains' own intermediates
    (from the plain versions) at ``batch`` images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        lp[key] = quant.quantize_weight_device(lp[key])
    d, h, t, nh, hd = (CFG.embed_dim, CFG.hidden_dim, CFG.num_tokens,
                       CFG.num_heads, CFG.head_dim)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    F = torch.nn.functional
    eps = CFG.eps

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
                lambda: F.layer_norm(x.float(), (d,), lp["ln1_w"], lp["ln1_b"], eps)),
        ln_case("layer_norm LN2 (fp32 in, fp32 out; W8A8)", "layernorm", ax1,
                lp["ln2_w"], lp["ln2_b"], f32,
                lambda: F.layer_norm(ax1, (d,), lp["ln2_w"], lp["ln2_b"], eps)),
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
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG, w8a8=True),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG,
                                                                     w8a8=True),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"int8": gemm_ops, "bf16": attn_ops}),
        dict(name="fused_encoder_layer int8 weights (the chain of 7 launches)",
             counter="fused_block_int8w", tol=BF16_TOL,
             min_same=MIN_SAME_INT8_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"bf16": gemm_ops + attn_ops}),
    ]
    return run_cases(cases, batch)


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


def _outputs(value) -> list:
    return list(value) if isinstance(value, tuple) else [value]


def run_cases(cases: list[dict], batch: int) -> list[dict]:
    rows = []
    for case in cases:
        outs, refs = _outputs(case["kernel"]()), _outputs(case["plain"]())
        torch.cuda.synchronize()
        errs = [max_err(o, r, case["tol"]) for o, r in zip(outs, refs)]
        err = max(e[0] for e in errs)
        within = all(e[1] for e in errs)
        same = min(e[2] for e in errs)
        scale = max(float(r.float().abs().max()) for r in refs)
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        library_ms = None
        if case["library"] is not None:
            try:
                library_ms = time_ms(case["library"])
            except RuntimeError as exc:  # e.g. _int_mm refusing a shape
                print(f"  library call refused: {str(exc).splitlines()[0]}")
        row = dict(name=case["name"], counter=case["counter"], max_abs_err=err,
                   tol=case["tol"], within=within, same=same,
                   ms=time_ms(case["kernel"]),
                   plain_ms=time_ms(case["plain"], reps=PLAIN_REPS),
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        print(f"  B={batch} {row['name']}: max_abs_err {err:.3e} "
              f"(|plain| up to {scale:.3g}; tol rtol {row['tol'][0]} atol {row['tol'][1]}; "
              f"{same:.2%} bit-identical) "
              f"{row['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"plain {row['plain_ms']:.4f} ms, library {lib} ms", flush=True)
        check(within and same >= case["min_same"],
              f"B={batch} {row['name']} within tolerance of its plain version, "
              f"bit-identical share {same:.4f} >= {case['min_same']}")
    return rows


def fp32_layer_norm_check(dev) -> None:
    """The LN kernel is the one link with an fp32 variant: hold it tightly."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((SMOKE_BATCH * CFG.num_tokens, CFG.embed_dim), generator=gen,
                    device=dev) * 2
    w = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1 + 1
    b = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1
    err, within, _ = max_err(layernorm.layer_norm(x, w, b, CFG.eps),
                             layernorm.layer_norm_reference(x, w, b, CFG.eps), F32_TOL)
    check(within, f"layer_norm fp32 in/out: max_abs_err {err:.3e} "
                  f"(tol rtol {F32_TOL[0]} atol {F32_TOL[1]})")


def read_counts() -> dict:
    return {key: getattr(mod, attr) for key, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def fp32_logits(params: dict, images: np.ndarray, dev) -> torch.Tensor:
    stacked = vit.stack_params(params, CFG, param_dtype=torch.float32, device=dev)
    out = []
    for start in range(0, len(images), SMOKE_BATCH):
        batch = torch.from_numpy(images[start:start + SMOKE_BATCH]).to(dev)
        out.append(vit.forward(batch, stacked, CFG, compute_dtype=torch.float32,
                               return_logits=True))
    return torch.cat(out)


def decisive_images(params: dict, dev) -> np.ndarray:
    """40 seeded images on which the fp32 plain model's top-2 logits are at
    least MIN_LOGIT_GAP apart, drawn in order from a seeded pool."""
    pool = fixtures.random_images(CFG, n=4 * N_IMAGES, seed=1)
    top2 = fp32_logits(params, pool, dev).topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    keep = np.flatnonzero(gaps >= MIN_LOGIT_GAP)[:N_IMAGES]
    if len(keep) < N_IMAGES:
        raise RuntimeError(f"only {len(keep)} decisive images in the pool")
    return pool[keep]


@contextlib.contextmanager
def plain_chain():
    """The engine's encoder layers through the chain's plain versions."""
    kernel_version = fused_block.fused_encoder_layer
    fused_block.fused_encoder_layer = fused_block.fused_encoder_layer_reference
    try:
        yield
    finally:
        fused_block.fused_encoder_layer = kernel_version


def adversarial_weights() -> dict:
    """Phase 3c's weights: seeded adversarial ViT-B/16 weights with the
    classifier head scaled by HEAD_SCALE."""
    params = fixtures.adversarial_params(CFG, seed=0)
    params["heads_head_weight"] = params["heads_head_weight"] * HEAD_SCALE
    return params


def make_workspace(ws: Path, dev, params: dict) -> tuple:
    """Weights, decisive images and the fp32 answer file in ``ws``, and a
    seeded calibration binary."""
    t0 = time.perf_counter()
    ws.mkdir(parents=True, exist_ok=True)
    binfmt.save_weights(ws / "Network", fixtures.params_to_positional(params, CFG),
                        CFG)
    binfmt.save_image_data(ws / "calib.bin",
                           fixtures.random_images(CFG, n=N_CALIB, seed=99))
    # The answer: the weights as the loader sees them (6-decimal rounded),
    # through the port's plain fp32 path on the card.
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    with torch.inference_mode():
        images = decisive_images(rounded, dev)
    binfmt.save_image_data(ws / "input.bin", images)
    ref_engine = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                 param_dtype=torch.float32,
                                 compute_dtype=torch.float32,
                                 attention_impl="xla", device=dev)
    ref_probs = ref_engine.run(images)
    del ref_engine
    results.write_results(ws / "answer.txt", ref_probs)
    print(f"  workspace: {CFG.name} weights, {N_IMAGES} images, fp32 answer "
          f"file in {time.perf_counter() - t0:.1f} s", flush=True)
    return rounded, images, ref_probs


def run_cli(ws: Path, mode: str, ref_probs: np.ndarray) -> tuple:
    """One main-path run through the CLI: the counts of exactly this run, and
    the max abs error of its result file's probabilities."""
    flags = list(MODES[mode])
    if mode.endswith("_outlier"):
        flags += ["--calibrate", str(ws / "calib.bin")]
    argv = ["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
            "--output", str(ws / f"result_{mode}.txt"),
            "--answer", str(ws / "answer.txt"), "--backend", "gpu",
            "--attention", "flash", "--config", CFG.name,
            "--batch-size", str(SMOKE_BATCH), *flags]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    print("  " + out.getvalue().strip().replace("\n", "\n  "))
    check(rc == 0 and "Comparator: files match." in out.getvalue(),
          f"cli --backend gpu --attention flash {' '.join(flags)}: rc {rc}, "
          "comparator green")
    batches = -(-N_IMAGES // SMOKE_BATCH)
    expected = {key: PER_LAYER[mode].get(key, 0) * CFG.depth * batches
                for key in COUNTERS}
    check(counts == expected, f"launches on the {mode} main path {counts}, "
                              f"expected {expected}")
    lines = [results.parse_result_line(line) for line in
             (ws / f"result_{mode}.txt").read_text().splitlines()]
    file_err = max(abs(p - float(ref_probs[i].max())) for i, (_, p) in
                   enumerate(lines))
    print(f"  {mode}: result-file probabilities vs the fp32 answer: max abs "
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

    print("== phase 4: throughput", flush=True)
    with torch.inference_mode():
        throughput({"bf16": engine, **engines, "w8a8_outlier": outlier_engine}, dev)

    # Each row's launches: from the main-path run that drives its kernel.
    runs = [(counts, r) for r in rows] + [
        (int8_counts["int8" if r["counter"].endswith("int8w") else "w8a8"], r)
        for r in int8_rows] + [(outlier_counts["w8a8_outlier"], r)
                               for r in outlier_rows]
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

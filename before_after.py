#!/usr/bin/env python3
"""A parent tree's bf16 GEMMs and paths beside this tree's, on one card.

    python3 before_after.py --parent DIR [--pairs N]

Run from the repository root on a machine with a card and the CUDA toolkit.
DIR holds the parent commit's files, unpacked into a git-ignored directory
of the checkout, for example::

    mkdir -p scratch_tree/parent && git archive HEAD~1 | tar -x -C scratch_tree/parent

Each tree is measured by ``before_after.py --figures ROOT`` in a process of
its own, with ROOT's package (built from ROOT's sources) and this file's
figures, in turns: parent, this, this, parent. A side's figure is the mean
of its two runs. The figures (ms):

* row 3's four GEMMs (``fused_linear``, ViT-B/16's shapes and epilogues) at
  B = 16 and 256, and row 5c's (``fused_linear`` with an int8 w and its
  scale, the int8-weight chain's epilogues) at the same shapes;
* row 5b's four W8A8 GEMMs (``fused_linear_w8a8``, the W8A8 chain's
  epilogues) and row 6c's (with the bf16 side product at the calibrated
  chain's widths: int8 K 640 / 768 / 640 / 2944, K_hi 128 / 96 / 128 /
  128) at ViT-B/16's shapes, B = 16 and 256, on the weights in the layout
  each tree's W8A8 GEMM takes (``models/quant.k_major`` where the tree has
  it, row-major before);
* row 4 (``packed_fused_attention``) at ViT-B/16's shape, B = 16 and 256,
  and row 11 (``packed_attention_bwd``) at ViT-B/16's, B = 64, bf16 dqkv,
  and ViT-L/16@384's, B = 32, bf16 and fp32 dqkv (the ``fused`` route's);
* row 8 (``single_pass_attention``) at ViT-B/16's heads, B = 16 and 256,
  as split heads and as the permuted views of a qkv GEMM output, at
  ViT-L/16@384's T = 577 (B = 8) and at the route's last T, 1024 (B = 4);
* row 9 (``blockwise_attention_fwd``) at chip_smoke.py's FLASH_ROWS
  shapes (ViT-L/16@512's T = 1025 at B = 4 and 16, ViT-H/14@518's 1370,
  the odd tail 1337, hd 128 at 1153), and with the LSE at T = 1025, B = 16;
  row 12 (``blockwise_attention_bwd``) at the FLASH_ROWS shapes;
* row 14a's forms (``linear_wgrad``, ``linear_dgrad``,
  ``fused_linear_with_gelu``) at ViT-B/16's B = 16 and 64 and at
  ViT-L/16@384's widths at B = 8;
* rows 2 and 5d (``layer_norm`` at ViT-B/16's D): LN1 (bf16 in) and LN2
  (fp32 in), with bf16 out (row 2) and fp32 out (row 5d), at B = 16 and
  256; row 14c (``column_sum``) on ViT-B/16's fp32 dqkv [M, 3D], bf16 dOut
  [M, D] and the LN backward's fp32 partial rows at B = 16 and 64 (as many
  as the tree's ``layernorm.bwd_partial_rows`` gives, ceil(M / 64) where the
  tree lacks it);
* row 14b (``layer_norm_bwd``) in its two chain forms, LN2 (fp32 x, + bf16
  dOut, fp32 dx) and LN1 (bf16 x, + fp32 dx2, bf16 dx), at ViT-B/16's
  B = 16 and 64 and ViT-L/16@384's B = 32 (host-bound calls: a figure the
  best of 10 timings);
* row 5a (``quantize_rows``) at its four ViT-B/16 sites (the fp32 LN1 and
  LN2 outputs [M, 768], the bf16 context [M, 768], the fp32 GELU'd hidden
  [M, 3072]) and row 6a (``quantize_rows_split``) at its three (LN1 and
  LN2 768 / 640, the hidden 3072 / 2944: the calibrated chain's int8
  widths), at B = 16 and 256; row 6b (``quantize_rows_masked``) on ViT-B/16's
  bf16 context (12 heads of 64, tails of 8) at B = 16 and 256;
* the ViT-B/16 bf16 forward at B = 64 and 256; W8A8, int8 weights and
  calibrated W8A8 at 256; the ViT-Ti and ViT-S stacks at 16 and 256;
* the ViT-B/16 ``fused`` AdamW step at B = 64 and ViT-L/16@384's at 32;
* ViT-L/16@512 (T = 1025, row 9's route) at B = 16: the bf16 ``flash``
  forward and the ``fused`` and ``flash`` AdamW steps (rows 9 and 12 are
  the ``flash`` step's attention).

Then the host-bound figures (the ViT-Ti and ViT-S stacks at B = 16, 84
launches a forward) two ways, N times each (default 10):

* process pairs, in alternating order: each tree's package in a process of
  its own, a figure the best of 10 timings of 10 forwards. Reported: each
  pair's ratio, their median and spread. A process's host speed moves with
  the cores it shares (the same tree has read 2.5 and 4.1 ms in two
  processes), so these mostly measure that;
* library swaps, in one process (``--swap DIR N``): this tree's package
  launching through its own kernel library and through the parent's, in
  alternating windows, a figure the best of 3 timings of 10 forwards.
  Every entry point the forward calls must have the same signature in
  both (the proxy raises otherwise). This holds the host and the Python
  fixed and measures what the kernel layer costs; a change to the
  forward's Python shows only in the pairs.

Gates (slower only, so a later tree that is faster passes): W8A8, int8
weights and calibrated W8A8 at B = 256 at most 3% slower than the parent's;
rows 5b and 6c at each of their shapes at B = 256 at most 3% slower;
rows 5a and 6a at each of their sites at B = 256 at most 3% slower;
row 14b in both forms at ViT-B/16 B = 64 and ViT-L/16@384 B = 32 and row
6b at B = 256 at most 3% slower;
row 4 at ViT-B/16 B = 256, row 11 at each of its shapes and the ViT-B/16
bf16 forward at B = 256 at most 3% slower (row 4 shares its kernel body
with row 8, row 11 its design with row 12); the ViT-B/16 ``fused`` AdamW
step at B = 64 (96 column sums and 24 LNs a step) at most 3% slower; the
median of the library swaps' ViT-Ti stack ratios at B = 16 (its LNs at D
= 192) at most 5% slower. Exits 1 if a gate fails, 2 without ``--parent``. The last line is
one JSON object with every run's figures, the pairs and the gates.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

STEADY_PATHS_TOL = 0.03
HOST_BOUND_TOL = 0.05
DEFAULT_PAIRS = 10
SMOKE_BATCH = 16
THROUGHPUT_BATCHES = (64, 256)
GEMM_BATCHES = (16, 256)
LN_BATCHES = (16, 256)  # rows 2 and 5d
QUANT_BATCHES = (16, 256)  # rows 5a and 6a
# (row, site, width, int8 columns of the split (None: the whole row), input
# dtype, scale) of rows 5a and 6a at ViT-B/16: the W8A8 and calibrated
# chains' quantizes (chip_smoke.py phases 2b and 2c), at about their inputs'
# magnitudes there.
QUANT_SITES = (("5a", "LN1", 768, None, torch.float32, 1.0),
               ("5a", "context", 768, None, torch.bfloat16, 0.5),
               ("5a", "LN2", 768, None, torch.float32, 1.0),
               ("5a", "GELU'd hidden", 3072, None, torch.float32, 0.5),
               ("6a", "LN1", 768, 640, torch.float32, 1.0),
               ("6a", "LN2", 768, 640, torch.float32, 1.0),
               ("6a", "GELU'd hidden", 3072, 2944, torch.float32, 0.5))
COLSUM_BATCHES = (16, 64)  # row 14c: phase 2e's and 4b's training batches
# The LN backward's rows a partial row where a tree has no bwd_partial_rows.
LN_BWD_ROWS_PER_BLOCK = 64
# (name, width, tokens, batch) of row 14b's figures; the gate takes the
# larger batch of each config.
LN_BWD_SHAPES = (("ViT-B/16", 768, 197, 16), ("ViT-B/16", 768, 197, 64),
                 ("ViT-L/16@384", 1024, 577, 32))
LN_BWD_GATED = ("ViT-B/16 B=64", "ViT-L/16@384 B=32")
MASKED_BATCHES = (16, 256)  # row 6b at ViT-B/16's context
# (name, width, hidden width, tokens, batch) of row 14a's figures.
GRAD_SHAPES = (("ViT-B/16", 768, 3072, 197, 16), ("ViT-B/16", 768, 3072, 197, 64),
               ("ViT-L/16@384", 1024, 4096, 577, 8))
# (name, heads, head dim, tokens, batch, dqkv dtypes) of rows 4 (no dtypes:
# the forward) and 11.
ATTN_SHAPES = (("ViT-B/16", 12, 64, 197, 16, ()), ("ViT-B/16", 12, 64, 197, 256, ()),
               ("ViT-B/16", 12, 64, 197, 64, (torch.bfloat16,)),
               ("ViT-L/16@384", 16, 64, 577, 32, (torch.bfloat16, torch.float32)))
# (name, heads, head dim, tokens, batch, as the permuted views of a packed
# GEMM output) of row 8's figures.
SINGLE_SHAPES = (("ViT-B/16", 12, 64, 197, 16, False), ("ViT-B/16", 12, 64, 197, 16, True),
                 ("ViT-B/16", 12, 64, 197, 256, False),
                 ("ViT-B/16", 12, 64, 197, 256, True),
                 ("ViT-L/16@384", 16, 64, 577, 8, False),
                 ("the route's last T", 16, 64, 1024, 4, False))
# (name, tokens, heads, head dim, batch, with the LSE) of row 9's figures;
# row 12's at each shape without the LSE.
FLASH_SHAPES = (("ViT-L/16@512", 1025, 16, 64, 4, False),
                ("ViT-L/16@512", 1025, 16, 64, 16, False),
                ("ViT-L/16@512", 1025, 16, 64, 16, True),
                ("ViT-H/14@518", 1370, 16, 80, 4, False),
                ("odd tail", 1337, 16, 64, 4, False), ("hd 128", 1153, 8, 128, 2, False))
LONG_BATCH = 16  # ViT-L/16@512's forward and step
N_CALIB = 16
TRAIN_LR = 1e-3
TRAIN_BATCH = 64  # ViT-B/16
LARGE_TRAIN_BATCH = 32  # ViT-L/16@384
REPS = 10
WINDOWS = 10  # the host-bound figures (stacks, row 14b): best of this many timings
SWAP_WINDOWS = 3  # the library swaps: best of this many timings
PROCESS_TIMEOUT = 900


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


def gemm_figures(pkg, dev) -> dict:
    """Row 3's four GEMMs with their chain's epilogues, and row 14a's forms
    (the wgrads, the dgrads with fc2's through the GELU gradient, the fc1
    pair)."""
    linear, cfg = pkg["linear"], pkg["VIT_B_16_224"]
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {}
    d, h = cfg.embed_dim, cfg.hidden_dim
    for batch in GEMM_BATCHES:
        m = batch * cfg.num_tokens
        for name, k, n, kw in (("qkv", d, 3 * d, {}), ("out", d, d, "res"),
                               ("fc1", d, h, {"fuse_gelu": True}), ("fc2", h, d, "res")):
            x, w, b = rnd(m, k), rnd(k, n, std=0.02), rnd(n, std=0.02, dtype=f32)
            if kw == "res":
                kw = {"residual": rnd(m, n, dtype=f32), "out_dtype": f32}
            out[f"row 3 {name} ViT-B/16 B={batch}"] = time_ms(
                lambda: linear.fused_linear(x, w, b, **kw))
        # Row 5c: the int8-weight chain's epilogues (chip_smoke.py phase 2b).
        for name, k, n, kw in (("qkv", d, 3 * d, {}),
                               ("out", d, d, {"residual": bf, "out_dtype": f32}),
                               ("fc1", d, h, {"fuse_gelu": True}),
                               ("fc2", h, d, {"residual": f32})):
            x, b = rnd(m, k), rnd(n, std=0.02, dtype=f32)
            wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                               dtype=torch.int8)
            sw = rnd(n, std=1e-4, dtype=f32).abs() + 1e-4
            kw = {key: rnd(m, n, dtype=v) if key == "residual" else v
                  for key, v in kw.items()}
            out[f"row 5c {name} ViT-B/16 B={batch}"] = time_ms(
                lambda: linear.fused_linear(x, wq, b, w_scale=sw, **kw))
    for cfg_name, d, h, t, batch in GRAD_SHAPES:
        m = batch * t
        tag = f"{cfg_name} B={batch}"
        for name, k, n in (("qkv", d, 3 * d), ("out", d, d), ("fc1", d, h), ("fc2", h, d)):
            x, dy, w = rnd(m, k), rnd(m, n, std=0.01), rnd(k, n, std=0.02)
            out[f"row 14a wgrad {name} {tag}"] = time_ms(lambda: linear.linear_wgrad(x, dy))
            if name == "fc2":
                pre = rnd(m, k, dtype=f32)
                out[f"row 14a dgrad fc2 * gelu' {tag}"] = time_ms(
                    lambda: linear.linear_dgrad(dy, w, gelu_grad_of=pre, out2_dtype=bf))
            else:
                out[f"row 14a dgrad {name} {tag}"] = time_ms(
                    lambda: linear.linear_dgrad(dy, w, out_dtype=bf if name == "out" else f32))
        x, w1, b1 = rnd(m, d), rnd(d, h, std=0.02), rnd(h, std=0.02, dtype=f32)
        out[f"row 14a fc1 pair {tag}"] = time_ms(
            lambda: linear.fused_linear_with_gelu(x, w1, b1))
    return out


# (name, int8 K, N, K_hi of the side product, epilogue) of rows 5b and 6c
# at ViT-B/16's widths: the W8A8 chain's epilogues (chip_smoke.py phases
# 2b and 2c); row 5b's K is the whole input width, row 6c's the int8 part.
W8A8_SHAPES = (("qkv", 768, 640, 2304, 128, {"out_dtype": torch.bfloat16}),
               ("out", 768, 768, 768, 96, {"residual": torch.bfloat16,
                                          "out_dtype": torch.float32}),
               ("fc1", 768, 640, 3072, 128, {"fuse_gelu": True, "out_dtype": torch.float32}),
               ("fc2", 3072, 2944, 768, 128, {"residual": torch.float32,
                                            "out_dtype": torch.bfloat16}))


def w8a8_figures(pkg, dev) -> dict:
    """Rows 5b and 6c at W8A8_SHAPES and GEMM_BATCHES on seeded int8
    operands, w in the layout the tree's W8A8 GEMM takes. Taken last: right
    after them the memory-bound LN and attention figures, unchanged kernels,
    read 2-5% slower in the tree whose W8A8 GEMMs ran faster."""
    linear, quant, cfg = pkg["linear"], pkg["quant"], pkg["VIT_B_16_224"]
    # K-major (the .t() of an [N, K] tensor) where the tree has the layout,
    # else row-major: one allocation of the same size either way, so that
    # both trees leave the caching allocator as the other does for the
    # figures that follow.
    k_major = hasattr(quant, "k_major")
    gen = torch.Generator(device=dev).manual_seed(16)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {}
    for batch in GEMM_BATCHES:
        m = batch * cfg.num_tokens
        for name, k, k8, n, k_hi, kw in W8A8_SHAPES:
            kw = {key: rnd(m, n, dtype=v) if key == "residual" else v
                  for key, v in kw.items()}
            b = rnd(n, std=0.02, dtype=torch.float32)
            for row, kq in (("5b", k), ("6c", k8)):
                xq = torch.randint(-127, 128, (m, kq), generator=gen, device=dev,
                                   dtype=torch.int8)
                wq = torch.randint(-127, 128, (n, kq) if k_major else (kq, n),
                                   generator=gen, device=dev, dtype=torch.int8)
                wq = wq.t() if k_major else wq
                sx = torch.rand((m, 1), generator=gen, device=dev) * 1e-2 + 1e-3
                sw = torch.rand(n, generator=gen, device=dev) * 1e-4 + 1e-5
                side = {}
                if row == "6c":
                    side = {"x_hi": rnd(m, k_hi), "w_hi": rnd(k_hi, n, std=0.02)}
                out[f"row {row} {name} ViT-B/16 B={batch}"] = time_ms(
                    lambda: linear.fused_linear_w8a8(xq, sx, wq, sw, b, **side, **kw))
    return out


def reduction_figures(pkg, dev) -> dict:
    """Rows 2 and 5d (``layer_norm``: LN1 on bf16 x, LN2 on the fp32
    stream, each with bf16 and fp32 out) at LN_BATCHES, row 14c
    (``column_sum`` on the fp32 dqkv, the bf16 dOut and the LN backward's
    fp32 partial rows) at COLSUM_BATCHES, at ViT-B/16's widths, and row 14b
    (``layer_norm_bwd``, LN2 and LN1) at LN_BWD_SHAPES, on seeded inputs
    (chip_smoke.py phases 2, 2b, 2e and 2f)."""
    layernorm, cfg = pkg["layernorm"], pkg["VIT_B_16_224"]
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    d, t = cfg.embed_dim, cfg.num_tokens
    w = torch.randn(d, generator=gen, device=dev) * 0.02 + 1.0
    b = torch.randn(d, generator=gen, device=dev) * 0.02
    out = {}
    for batch in LN_BATCHES:
        for name, x_dtype in (("LN1", bf), ("LN2", f32)):
            x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(x_dtype)
            for row, out_dtype in (("row 2", bf), ("row 5d", f32)):
                tag = "bf16" if out_dtype == bf else "fp32"
                out[f"{row} layer_norm {name} ({tag} out) ViT-B/16 B={batch}"] = time_ms(
                    lambda: layernorm.layer_norm(x, w, b, cfg.eps, out_dtype=out_dtype))
    for batch in COLSUM_BATCHES:
        m = batch * t
        partial_rows = (layernorm.bwd_partial_rows(m, d)
                        if hasattr(layernorm, "bwd_partial_rows")
                        else -(-m // LN_BWD_ROWS_PER_BLOCK))
        for name, shape, dtype in (
                ("dqkv (fp32)", (m, 3 * d), f32), ("dOut (bf16)", (m, d), bf),
                ("LN partial rows (fp32)", (partial_rows, d), f32)):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            out[f"row 14c column_sum {name} ViT-B/16 B={batch}"] = time_ms(
                lambda: layernorm.column_sum(x))
    for cfg_name, d, t, batch in LN_BWD_SHAPES:
        m = batch * t
        w = torch.randn(d, generator=gen, device=dev) * 0.02 + 1.0
        dy = torch.randn((m, d), generator=gen, device=dev) * 0.01
        for name, x_dtype, g_dtype, out_dtype in (("LN2", f32, bf, f32),
                                                  ("LN1", bf, f32, bf)):
            x = torch.randn((m, d), generator=gen, device=dev).to(x_dtype)
            g = (torch.randn((m, d), generator=gen, device=dev) * 0.01).to(g_dtype)
            # The call is host-bound (its wrapper and two column sums'):
            # the best of WINDOWS timings, as the host-bound stacks.
            out[f"row 14b layer_norm_bwd {name} {cfg_name} B={batch}"] = min(
                time_ms(lambda: layernorm.layer_norm_bwd(x, dy, w, cfg.eps, residual=g,
                                                         out_dtype=out_dtype))
                for _ in range(WINDOWS))
    return out


def quantize_figures(pkg, dev) -> dict:
    """Rows 5a and 6a at QUANT_SITES and QUANT_BATCHES, and row 6b at
    MASKED_BATCHES, on seeded inputs."""
    quantize, cfg = pkg["quantize"], pkg["VIT_B_16_224"]
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for batch in QUANT_BATCHES:
        m = batch * cfg.num_tokens
        for row, site, k, mq, dtype, std in QUANT_SITES:
            x = (torch.randn((m, k), generator=gen, device=dev) * std).to(dtype)
            if mq is None:
                fn = lambda x=x: quantize.quantize_rows(x)
            else:
                fn = lambda x=x, mq=mq: quantize.quantize_rows_split(x, mq, torch.bfloat16)
            out[f"row {row} quantize {site} ViT-B/16 B={batch}"] = time_ms(fn)
    nh, hd, kh = cfg.num_heads, cfg.head_dim, max(2, cfg.head_dim // 8)
    for batch in MASKED_BATCHES:
        ctx = torch.randn((batch * cfg.num_tokens, nh * hd), generator=gen, device=dev)
        ctx[:, hd - 1::hd] *= 30.0  # outlier channels in the tails
        ctx = ctx.to(torch.bfloat16)
        out[f"row 6b quantize context ViT-B/16 B={batch}"] = time_ms(
            lambda: quantize.quantize_rows_masked(ctx, nh, hd, kh))
    return out


def attention_figures(pkg, dev) -> dict:
    """Row 4 and row 11 at ATTN_SHAPES, on seeded
    unit-scale qkv and dO at 0.01 (chip_smoke.py phases 2 and 2f)."""
    attention, bf = pkg["attention"], torch.bfloat16
    out = {}
    for cfg_name, nh, hd, t, batch, dtypes in ATTN_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        d = nh * hd
        qkv = torch.randn((batch, t, 3 * d), generator=gen, device=dev).to(bf)
        tag = f"{cfg_name} B={batch}"
        if not dtypes:
            out[f"row 4 attention {tag}"] = time_ms(
                lambda: attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd))
            continue
        do = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.01).to(bf)
        for o in dtypes:
            out[f"row 11 attention backward ({o}) {tag}"] = time_ms(
                lambda: attention.packed_attention_bwd(qkv, do, nh, hd, out_dtype=o))
    return out


def long_attention_figures(pkg, dev) -> dict:
    """Rows 8 and 9 at SINGLE_SHAPES and FLASH_SHAPES on seeded unit-scale
    inputs (chip_smoke.py phases 2h and 2g)."""
    attention, bf = pkg["attention"], torch.bfloat16
    out = {}
    for name, nh, hd, t, batch, as_view in SINGLE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t + batch)
        if as_view:
            qkv = torch.randn((batch, t, 3 * nh * hd), generator=gen, device=dev).to(bf)
            q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = (torch.randn((batch, nh, t, hd), generator=gen, device=dev).to(bf)
                       for _ in range(3))
        tag = f"{name} B={batch} T={t}" + (" (views)" if as_view else "")
        out[f"row 8 single-pass attention {tag}"] = time_ms(
            lambda: attention.single_pass_attention(q, k, v, hd))
    for name, t, nh, hd, batch, lse in FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t + batch)
        qkv = torch.randn((batch, t, 3 * nh * hd), generator=gen, device=dev).to(bf)
        tag = f"{name} B={batch} T={t} hd={hd}" + (" with LSE" if lse else "")
        out[f"row 9 blockwise forward {tag}"] = time_ms(
            lambda: attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=lse))
        if lse:
            continue
        o, l = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True)
        do = (torch.randn((batch, t, nh * hd), generator=gen, device=dev) * 0.01).to(bf)
        out[f"row 12 blockwise backward {tag}"] = time_ms(
            lambda: attention.blockwise_attention_bwd(qkv, o, l, do, nh, hd))
    return out


def long_config(pkg):
    """ViT-L/16@512: ViT-L/16@384's geometry at 512 (chip_smoke.LONG_CFG)."""
    return dataclasses.replace(pkg["VIT_L_16_384"], name="vit_l_16_512", img_size=512)


def long_forward_figures(pkg, dev) -> dict:
    """The ViT-L/16@512 bf16 ``flash`` forward at B = 16 (ms a forward)."""
    cfg = long_config(pkg)
    engine = pkg["InferenceEngine"](cfg, pkg["fixtures"].random_params(cfg, seed=0),
                                    batch_size=LONG_BATCH, attention_impl="flash",
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(LONG_BATCH)
    images = torch.randn((LONG_BATCH, 3, cfg.img_size, cfg.img_size), generator=gen,
                         device=dev)
    out = {f"forward {cfg.name} bf16 B={LONG_BATCH}": time_ms(
        lambda: engine.forward(images), reps=5)}
    del engine
    torch.cuda.empty_cache()
    return out


def stack_figures(pkg, dev, batches, windows: int = WINDOWS) -> dict:
    """The ViT-Ti and ViT-S bf16 stacks (one stack call a forward) at
    ``batches``, each figure the best of ``windows`` timings."""
    out = {}
    for cfg in (pkg["VIT_TINY_16_224"], pkg["VIT_S_16_224"]):
        engine = pkg["InferenceEngine"](cfg, pkg["fixtures"].random_params(cfg, seed=0),
                                        batch_size=SMOKE_BATCH, attention_impl="flash",
                                        device=dev)
        for batch in batches:
            gen = torch.Generator(device=dev).manual_seed(batch)
            images = torch.randn((batch, 3, cfg.img_size, cfg.img_size), generator=gen,
                                 device=dev)
            out[f"forward {cfg.name} bf16 stack B={batch}"] = min(
                time_ms(lambda: engine.forward(images)) for _ in range(windows))
    return out


def forward_figures(pkg, dev) -> dict:
    """ViT-B/16 bf16 at B = 64 and 256; W8A8, int8 weights and calibrated
    W8A8 at 256 (ms a forward)."""
    cfg, fixtures = pkg["VIT_B_16_224"], pkg["fixtures"]
    params = fixtures.random_params(cfg, seed=0)
    calib = fixtures.random_images(cfg, n=N_CALIB, seed=5)
    engines = {mode: pkg["InferenceEngine"](cfg, params, batch_size=SMOKE_BATCH,
                                            attention_impl="flash", device=dev,
                                            quantize=q, calibrate=c)
               for mode, q, c in (("bf16", None, None), ("w8a8", "int8-w8a8", None),
                                  ("int8", "int8", None),
                                  ("w8a8_outlier", "int8-w8a8", calib))}
    out = {}
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, cfg.img_size, cfg.img_size), generator=gen,
                             device=dev)
        for mode, engine in engines.items():
            if mode == "bf16" or batch == THROUGHPUT_BATCHES[-1]:
                out[f"forward {cfg.name} {mode} B={batch}"] = time_ms(
                    lambda: engine.forward(images), reps=5)
    return out


def training_figures(pkg, dev) -> dict:
    """The fused AdamW step of ViT-B/16 at B = 64, ViT-L/16@384 at 32 and
    ViT-L/16@512 at 16, and the flash step of ViT-L/16@512 at 16 (ms a
    step)."""
    out = {}
    torch.cuda.empty_cache()
    for cfg, batch, impl in ((pkg["VIT_B_16_224"], TRAIN_BATCH, "fused"),
                             (pkg["VIT_L_16_384"], LARGE_TRAIN_BATCH, "fused"),
                             (long_config(pkg), LONG_BATCH, "fused"),
                             (long_config(pkg), LONG_BATCH, "flash")):
        images = pkg["fixtures"].random_images(cfg, n=batch, seed=4)
        ti = torch.from_numpy(images).to(dev)
        tl = torch.full((batch,), 4 % cfg.num_classes, dtype=torch.int64, device=dev)
        init, step = pkg["spmd"].make_train_step(cfg, device=dev, lr=TRAIN_LR,
                                                 compute_dtype=torch.bfloat16,
                                                 optimizer="adamw", attention_impl=impl)
        params = pkg["optim"].tree_map(lambda t: t.to(dev),
                                       pkg["vit"].init_params(cfg, seed=0, device="cpu"))
        state = init(params)
        out[f"train step {cfg.name} {impl} B={batch}"] = time_ms(
            lambda: step(params, state, ti, tl), reps=3)
        del params, state, init, step
        torch.cuda.empty_cache()
    return out


def figures_main(root: str, host_only: bool) -> int:
    """``--figures ROOT [--host]``: the figures with ROOT's package on the
    card (only the host-bound ones with --host), one JSON object on the last
    line naming the root its package came from."""
    sys.path.insert(0, str(Path(root).resolve()))
    import vit_with_opencl_tpu_torch as port
    from vit_with_opencl_tpu_torch import optim
    from vit_with_opencl_tpu_torch.config import (VIT_B_16_224, VIT_L_16_384,
                                                  VIT_S_16_224, VIT_TINY_16_224)
    from vit_with_opencl_tpu_torch.engine import InferenceEngine
    from vit_with_opencl_tpu_torch.harness import fixtures
    from vit_with_opencl_tpu_torch.models import quant, vit
    from vit_with_opencl_tpu_torch.ops import (_build, attention, layernorm, linear,
                                               quantize)
    from vit_with_opencl_tpu_torch.parallel import spmd
    pkg = dict(linear=linear, attention=attention, layernorm=layernorm, optim=optim,
               quantize=quantize,
               vit=vit, quant=quant, spmd=spmd, fixtures=fixtures,
               InferenceEngine=InferenceEngine, VIT_B_16_224=VIT_B_16_224,
               VIT_L_16_384=VIT_L_16_384, VIT_S_16_224=VIT_S_16_224,
               VIT_TINY_16_224=VIT_TINY_16_224)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    with torch.inference_mode():
        if host_only:
            out = stack_figures(pkg, dev, (SMOKE_BATCH,))
        else:
            out = gemm_figures(pkg, dev)
            out.update(reduction_figures(pkg, dev))
            out.update(quantize_figures(pkg, dev))
            out.update(attention_figures(pkg, dev))
            out.update(long_attention_figures(pkg, dev))
            out.update(forward_figures(pkg, dev))
            out.update(long_forward_figures(pkg, dev))
            out.update(stack_figures(pkg, dev, (SMOKE_BATCH, THROUGHPUT_BATCHES[-1])))
    if not host_only:
        out.update(training_figures(pkg, dev))
        with torch.inference_mode():
            out.update(w8a8_figures(pkg, dev))
    print(json.dumps({"root": str(Path(port.__file__).resolve().parents[1]), "ms": out}))
    return 0


class SharedEntries:
    """The parent's kernel library, its entry points callable where their
    signatures equal this tree's (any other raises when called)."""

    def __init__(self, lib, theirs: dict, ours: dict):
        self._lib = lib
        self._same = {n for n in ours if theirs.get(n) == ours[n]} | {"vit_error_string"}

    def __getattr__(self, name):
        if name not in self._same:
            raise RuntimeError(f"{name}: the parent's entry point has another signature")
        return getattr(self._lib, name)


def swap_main(parent: str, pairs: int) -> int:
    """``--swap DIR N``: the host-bound stacks at B = 16 in this process,
    this tree's package launching through its own kernel library and
    through DIR's (built from DIR's sources by DIR's ``_build``) in
    alternating windows, N of each; one JSON object on the last line."""
    import importlib.util
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vit_with_opencl_tpu_torch.config import VIT_S_16_224, VIT_TINY_16_224
    from vit_with_opencl_tpu_torch.engine import InferenceEngine
    from vit_with_opencl_tpu_torch.harness import fixtures
    from vit_with_opencl_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "vit_with_opencl_tpu_torch" / "ops" / "_build.py")
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    libs = {"this": _build.library(),
            "parent": SharedEntries(parent_build.library(), parent_build.SIGNATURES,
                                    _build.SIGNATURES)}
    dev = torch.device("cuda")
    out = {}
    with torch.inference_mode():
        for cfg in (VIT_TINY_16_224, VIT_S_16_224):
            engine = InferenceEngine(cfg, fixtures.random_params(cfg, seed=0),
                                     batch_size=SMOKE_BATCH, attention_impl="flash",
                                     device=dev)
            gen = torch.Generator(device=dev).manual_seed(SMOKE_BATCH)
            images = torch.randn((SMOKE_BATCH, 3, cfg.img_size, cfg.img_size),
                                 generator=gen, device=dev)
            ms = {"this": [], "parent": []}
            for i in range(2 * pairs):
                tag = ("this", "parent")[(i + i // 2) % 2]  # this, parent, parent, this, ...
                _build._lib = libs[tag]
                ms[tag].append(min(time_ms(lambda: engine.forward(images))
                                   for _ in range(SWAP_WINDOWS)))
            _build._lib = libs["this"]
            out[f"forward {cfg.name} bf16 stack B={SMOKE_BATCH}"] = ms
    print(json.dumps({"swaps": out}))
    return 0


def run_figures(root: Path, host_only: bool = False) -> dict:
    """``before_after.py --figures root`` in a process of its own: its
    figures, after checking that they came from root's package."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--figures", str(root)]
    proc = subprocess.run(cmd + (["--host"] if host_only else []), capture_output=True,
                          text=True, timeout=PROCESS_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"--figures {root} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    result = json.loads(lines[-1])
    if Path(result["root"]) != root:
        raise RuntimeError(f"--figures {root} measured the package of {result['root']}")
    return result["ms"]


def main(argv: list[str]) -> int:
    if "--parent" not in argv:
        print(__doc__)
        print("FAIL: no --parent DIR: nothing to compare")
        return 2
    parent = Path(argv[argv.index("--parent") + 1]).resolve()
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else DEFAULT_PAIRS
    here = Path(__file__).resolve().parent
    if not (parent / "vit_with_opencl_tpu_torch").is_dir() or parent == here:
        print(f"FAIL: {parent} holds no other tree's vit_with_opencl_tpu_torch")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)

    runs = [run_figures(root) for root in (parent, here, here, parent)]
    before = {k: (runs[0][k] + runs[3][k]) / 2 for k in runs[0]}
    after = {k: (runs[1][k] + runs[2][k]) / 2 for k in runs[1]}
    for key in before:
        b, a = before[key], after[key]
        print(f"before / after {key}: {b:.4f} / {a:.4f} ms ({b / a:.4f}x; runs "
              f"{runs[0][key]:.4f}, {runs[1][key]:.4f}, {runs[2][key]:.4f}, "
              f"{runs[3][key]:.4f})", flush=True)

    # The host-bound figures: pairs in alternating order (parent first, then
    # this tree first), each ratio this tree's ms over the parent's.
    pair_runs = []
    for i in range(pairs):
        order = (parent, here) if i % 2 == 0 else (here, parent)
        ms = {root: run_figures(root, host_only=True) for root in order}
        pair_runs.append({"parent": ms[parent], "this": ms[here]})
    ratios = {}
    for key in pair_runs[0]["parent"] if pairs else ():
        ratios[key] = [p["this"][key] / p["parent"][key] for p in pair_runs]
        r = ratios[key]
        print(f"pairs {key}: this / parent median {statistics.median(r):.4f}, "
              f"min {min(r):.4f}, max {max(r):.4f} over {len(r)} pairs "
              f"(ratios {', '.join(f'{v:.4f}' for v in r)})", flush=True)

    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--swap",
                           str(parent), str(pairs)], capture_output=True, text=True,
                          timeout=PROCESS_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"--swap exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    swaps = json.loads(proc.stdout.strip().splitlines()[-1])["swaps"]
    swap_ratios = {}
    for key, ms in swaps.items():
        r = [a / b for a, b in zip(ms["this"], ms["parent"])]
        swap_ratios[key] = r
        print(f"library swaps {key}: this / parent median {statistics.median(r):.4f}, "
              f"min {min(r):.4f}, max {max(r):.4f} over {len(r)} windows each "
              f"(this median {statistics.median(ms['this']):.4f} ms, parent "
              f"{statistics.median(ms['parent']):.4f})", flush=True)

    gates = {}
    for mode in ("w8a8", "int8", "w8a8_outlier"):
        key = f"forward vit_b_16_224 {mode} B={THROUGHPUT_BATCHES[-1]}"
        ratio = after[key] / before[key]
        gates[key] = ratio <= 1 + STEADY_PATHS_TOL
        print(f"{'ok  ' if gates[key] else 'FAIL'} {key}: this / parent {ratio:.4f} "
              f"(at most {STEADY_PATHS_TOL:.0%} slower; within {STEADY_PATHS_TOL:.0%} "
              f"either way: {abs(ratio - 1) <= STEADY_PATHS_TOL})", flush=True)
    for key in (k for k in after
                if (k.startswith(("row 5b ", "row 6c ", "row 5a ", "row 6a ", "row 6b "))
                    and k.endswith(f"B={GEMM_BATCHES[-1]}"))
                or (k.startswith("row 14b ") and k.endswith(LN_BWD_GATED))):
        ratio = after[key] / before[key]
        gates[key] = ratio <= 1 + STEADY_PATHS_TOL
        print(f"{'ok  ' if gates[key] else 'FAIL'} {key}: this / parent {ratio:.4f} "
              f"(at most {STEADY_PATHS_TOL:.0%} slower)", flush=True)
    for key in (f"row 4 attention ViT-B/16 B={THROUGHPUT_BATCHES[-1]}",
                *(k for k in after if k.startswith("row 11 ")),
                f"forward vit_b_16_224 bf16 B={THROUGHPUT_BATCHES[-1]}"):
        ratio = after[key] / before[key]
        gates[key] = ratio <= 1 + STEADY_PATHS_TOL
        print(f"{'ok  ' if gates[key] else 'FAIL'} {key}: this / parent {ratio:.4f} "
              f"(at most {STEADY_PATHS_TOL:.0%} slower: row 4 shares its body with "
              f"row 8, row 11 its design with row 12)", flush=True)
    key = f"train step vit_b_16_224 fused B={TRAIN_BATCH}"
    ratio = after[key] / before[key]
    gates[key] = ratio <= 1 + STEADY_PATHS_TOL
    print(f"{'ok  ' if gates[key] else 'FAIL'} {key}: this / parent {ratio:.4f} "
          f"(at most {STEADY_PATHS_TOL:.0%} slower: 96 column sums and 24 LNs a "
          f"step)", flush=True)
    key = f"forward vit_tiny_16_224 bf16 stack B={SMOKE_BATCH}"
    if key in swap_ratios:
        median = statistics.median(swap_ratios[key])
        gates[key] = median <= 1 + HOST_BOUND_TOL
        print(f"{'ok  ' if gates[key] else 'FAIL'} {key} (host-bound): median this / "
              f"parent {median:.4f} over {pairs} library swaps (at most "
              f"{HOST_BOUND_TOL:.0%} slower)", flush=True)
    print(json.dumps({"parent": str(parent), "card": smi.stdout.strip(), "runs": runs,
                      "pairs": pair_runs, "swaps": swaps, "gates": gates}))
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--swap":
        sys.exit(swap_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) >= 3 and sys.argv[1] == "--figures":
        sys.exit(figures_main(sys.argv[2], "--host" in sys.argv[3:]))
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the kernels from ``vit_with_opencl_tpu_torch/csrc`` itself (first
use), then runs four phases; any failure exits non-zero before the last line.

1. Device and build: the card's name and power limit, the build time.
2. Kernels against their plain versions at ViT-B/16 shapes (T = 197,
   D = 768, H = 3072) at the main path's batch of 16: both LN links, the four
   GEMMs of a layer, the packed attention and the whole encoder-layer chain.
   Each prints its max abs error beside its tolerance and its time (CUDA
   events) beside its bound, its plain version's time and a library
   yardstick: one PyTorch call where one computes the same function
   (``F.layer_norm``, ``torch.addmm``, ``F.scaled_dot_product_attention``),
   else ``torch.addmm`` followed by the rest of the epilogue as PyTorch ops.
3. The main path: a reference-format workspace (seeded ViT-B/16 weights,
   40 seeded images) goes through ``cli.main --backend gpu --attention
   flash``; the answer file comes from the port's plain fp32 path on the
   card with TF32 off. Requires "Comparator: files match.", bf16
   probabilities within 1e-3 of the fp32 path, and the kernel launch counts
   of 3 batches x 12 layers.
4. Throughput of the full-depth bf16 flash forward at batch 64 and 256,
   beside the sum of its kernels' times at the same batch.

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
    from vit_with_opencl_tpu_torch.models import vit
    from vit_with_opencl_tpu_torch.ops import (_build, attention, fused_block,
                                               layernorm, linear)
except ImportError as exc:  # run outside the repository
    print(f"FAIL: the port's package is not importable here: {exc}")
    sys.exit(1)

CFG = VIT_B_16_224
SMOKE_BATCH = 16  # the main path's batch (phase 3), hence phase 2's shapes
N_IMAGES = 40  # 3 batches of 16, the last one padded
THROUGHPUT_BATCHES = (64, 256)
REPS = 20
# Images whose fp32 top-2 logit gap is below this are left out of phase 3:
# with random weights over 1000 classes, near-ties are common, and bf16
# rounding may then swap the top-1 label although the probabilities agree
# to 1e-4. The comparator's exact-label gate should test the kernels, not a
# coin toss.
MIN_LOGIT_GAP = 0.05

# bf16 outputs: about 2 bf16 ulps; fp32 outputs: summation order.
BF16_TOL = (1.6e-2, 1e-2)  # (rtol, atol)
F32_TOL = (1e-4, 1e-4)
# A bf16 output must also be bit-identical to the plain version's almost
# everywhere: both round at the same points, and only another summation
# order may flip a rounding. A moved rounding point stays within 2 ulps but
# changes about half the elements. The chain compounds the flips of its 7
# launches (about 82% identical at ViT-B shapes on an H100).
MIN_SAME_KERNEL = 0.99
MIN_SAME_CHAIN = 0.7
PROB_TOL = 1e-3  # the reference's bf16 parity budget on probabilities

# Published dense peaks: (bf16 tensor FLOP/s, fp32 CUDA-core FLOP/s, bytes/s).
PEAKS = {"H100 PCIe": (756e12, 51e12, 2.0e12),
         "H100 NVL": (835e12, 60e12, 3.9e12),
         "H100": (989e12, 67e12, 3.35e12)}

REPLACES = {
    "layernorm": "vit_with_opencl_tpu/ops/layernorm.py:33",
    "linear": "vit_with_opencl_tpu/ops/linear.py:36",
    "attention": "vit_with_opencl_tpu/ops/attention.py:872",
    "fused_block": "vit_with_opencl_tpu/ops/fused_block.py:198",
}
SOURCES = {
    "layernorm": "vit_with_opencl_tpu_torch/csrc/layernorm.cu",
    "linear": "vit_with_opencl_tpu_torch/csrc/linear.cu",
    "attention": "vit_with_opencl_tpu_torch/csrc/attention.cu",
    "fused_block": "vit_with_opencl_tpu_torch/ops/fused_block.py",
}
MODULES = {"layernorm": layernorm, "linear": linear, "attention": attention,
           "fused_block": fused_block}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        failures.append(what)


def peaks() -> tuple:
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


def bound(nbytes: float, ops: float, tensor: bool) -> tuple:
    flops_peak, f32_peak, bw = peaks()
    t_bytes = nbytes / bw
    t_ops = ops / (flops_peak if tensor else f32_peak)
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


def kernel_rows(batch: int, dev, seed: int = 0) -> list[dict]:
    """Every kernel of the chain on the chain's own intermediates at
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

    def ln_bytes(in_b, out_b):
        return m * d * (in_b + out_b) + 2 * d * 4

    def gemm(name, inp, wkey, bkey, n, k_dim, out_dtype, **kw):
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4
        nbytes = m * k_dim * 2 + k_dim * n * 2 + n * 4 + m * n * (res_b + out_b)

        bias = lp[bkey].to(bf)

        def library():
            # cuBLAS with a bias epilogue, then any further epilogue as
            # library ops (no single call fuses a residual or a GELU).
            y = torch.addmm(bias, inp.reshape(m, k_dim), lp[wkey])
            if "residual" in kw:
                y = kw["residual"].reshape(m, n) + y
            if kw.get("fuse_gelu"):
                y = F.gelu(y, approximate="tanh")
            return y.to(out_dtype)

        return dict(
            name=name, module="linear", tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear(inp, lp[wkey], lp[bkey],
                                               out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_reference(inp, lp[wkey], lp[bkey],
                                                        out_dtype=out_dtype, **kw),
            library=library, bytes=nbytes, ops=2 * m * n * k_dim, tensor=True)

    cases = [
        dict(name="layer_norm LN1 (bf16 in, bf16 out)", module="layernorm",
             tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
             kernel=lambda: layernorm.layer_norm(x, lp["ln1_w"], lp["ln1_b"], CFG.eps),
             plain=lambda: layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"],
                                                          CFG.eps),
             library=lambda: F.layer_norm(x, (d,), b16["ln1_w"], b16["ln1_b"], CFG.eps),
             bytes=ln_bytes(2, 2), ops=8 * m * d, tensor=False),
        gemm("fused_linear qkv (+bias, bf16 out)", h1, "qkv_w", "qkv_b", 3 * d, d, bf),
        dict(name="packed_fused_attention (bf16)", module="attention", tol=BF16_TOL,
             min_same=MIN_SAME_KERNEL,
             kernel=lambda: attention.packed_fused_attention(qkv, num_heads=nh,
                                                             head_dim=hd),
             plain=lambda: attention.packed_fused_attention_reference(qkv, nh, hd),
             library=lambda: F.scaled_dot_product_attention(q, k, v),
             bytes=batch * t * 4 * d * 2, ops=4 * batch * nh * t * t * hd,
             tensor=True),
        gemm("fused_linear out-proj (+fp32 residual, +bias, fp32 out)", ctx,
             "out_w", "out_b", d, d, f32, residual=x),
        dict(name="layer_norm LN2 (fp32 in, bf16 out)", module="layernorm",
             tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
             kernel=lambda: layernorm.layer_norm(x1, lp["ln2_w"], lp["ln2_b"],
                                                 CFG.eps, out_dtype=bf),
             plain=lambda: layernorm.layer_norm_reference(
                 x1, lp["ln2_w"], lp["ln2_b"], CFG.eps, out_dtype=bf),
             library=lambda: F.layer_norm(x1, (d,), lp["ln2_w"], lp["ln2_b"], CFG.eps),
             bytes=ln_bytes(4, 2), ops=8 * m * d, tensor=False),
        gemm("fused_linear fc1 (+bias, _gelu_fast, bf16 out)", h2, "fc1_w", "fc1_b",
             h, d, bf, fuse_gelu=True),
        gemm("fused_linear fc2 (+fp32 residual, +bias, bf16 out)", hid, "fc2_w",
             "fc2_b", d, h, bf, residual=x1),
    ]
    weight_bytes = (4 * d * d + 2 * d * h) * 2 + (9 * d + h) * 4
    cases.append(dict(
        name="fused_encoder_layer (the chain of the 7 launches above)",
        module="fused_block", tol=BF16_TOL, min_same=MIN_SAME_CHAIN,
        kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG),
        plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG),
        library=None, bytes=2 * m * d * 2 + weight_bytes,
        ops=2 * m * d * (4 * d + 2 * h) + 4 * batch * t * t * d, tensor=True))

    rows = []
    for case in cases:
        out = case["kernel"]()
        ref = case["plain"]()
        torch.cuda.synchronize()
        err, within, same = max_err(out, ref, case["tol"])
        bound_ms, bound_by = bound(case["bytes"], case["ops"], case["tensor"])
        row = dict(name=case["name"], module=case["module"], max_abs_err=err,
                   tol=case["tol"], within=within,
                   ms=time_ms(case["kernel"]), plain_ms=time_ms(case["plain"]),
                   library_ms=(time_ms(case["library"]) if case["library"]
                               else None),
                   bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"  B={batch} {row['name']}: max_abs_err {err:.3e} "
              f"(tol rtol {row['tol'][0]} atol {row['tol'][1]}; "
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


def reset_counts() -> None:
    for module in MODULES.values():
        module.LAUNCHES = 0


def decisive_images(params: dict, dev) -> np.ndarray:
    """40 seeded images on which the fp32 plain model's top-2 logits are at
    least MIN_LOGIT_GAP apart, drawn in order from a seeded pool."""
    stacked = vit.stack_params(params, CFG, param_dtype=torch.float32, device=dev)
    pool = fixtures.random_images(CFG, n=4 * N_IMAGES, seed=1)
    gaps = []
    for start in range(0, len(pool), SMOKE_BATCH):
        batch = torch.from_numpy(pool[start:start + SMOKE_BATCH]).to(dev)
        logits = vit.forward(batch, stacked, CFG, compute_dtype=torch.float32,
                             return_logits=True)
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu())
    keep = np.flatnonzero(torch.cat(gaps).numpy() >= MIN_LOGIT_GAP)[:N_IMAGES]
    if len(keep) < N_IMAGES:
        raise RuntimeError(f"only {len(keep)} decisive images in the pool")
    return pool[keep]


def main_path(dev) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp)
        t0 = time.perf_counter()
        params = fixtures.random_params(CFG, seed=0)
        binfmt.save_weights(ws / "Network", fixtures.params_to_positional(params, CFG),
                            CFG)
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

        argv = ["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
                "--output", str(ws / "result.txt"), "--answer", str(ws / "answer.txt"),
                "--backend", "gpu", "--attention", "flash", "--config", CFG.name,
                "--batch-size", str(SMOKE_BATCH)]
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        counts = {name: module.LAUNCHES for name, module in MODULES.items()}
        print("  " + out.getvalue().strip().replace("\n", "\n  "))
        check(rc == 0 and "Comparator: files match." in out.getvalue(),
              f"cli --backend gpu --attention flash: rc {rc}, comparator green")

        batches = -(-N_IMAGES // SMOKE_BATCH)
        expected = {"layernorm": 2 * CFG.depth * batches,
                    "linear": 4 * CFG.depth * batches,
                    "attention": CFG.depth * batches,
                    "fused_block": CFG.depth * batches}
        check(counts == expected, f"launches on the main path {counts}, "
                                  f"expected {expected}")

        lines = [results.parse_result_line(line) for line in
                 (ws / "result.txt").read_text().splitlines()]
        file_err = max(abs(p - float(ref_probs[i].max())) for i, (_, p) in
                       enumerate(lines))
        engine = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                 attention_impl="flash", device=dev)
        probs = engine.run(images)
        prob_err = float(np.abs(probs - ref_probs).max())
        check(prob_err <= PROB_TOL and file_err <= PROB_TOL,
              f"bf16 flash probabilities vs fp32 plain: max abs err {prob_err:.3e} "
              f"(result file {file_err:.3e}), budget {PROB_TOL}")
    return counts, engine


def throughput(engine: InferenceEngine, dev) -> None:
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, CFG.img_size, CFG.img_size),
                             generator=gen, device=dev)
        engine.forward(images)  # warm-up
        ms = time_ms(lambda: engine.forward(images), reps=10)
        rows = kernel_rows(batch, dev, seed=batch)
        per_layer = sum(r["ms"] for r in rows if r["module"] != "fused_block")
        bound_layer = sum(r["bound_ms"] for r in rows if r["module"] != "fused_block")
        chain = next(r for r in rows if r["module"] == "fused_block")
        print(f"throughput B={batch}: {batch / ms * 1e3:.1f} img/s "
              f"({ms:.3f} ms per forward); kernels {CFG.depth} x {per_layer:.3f} ms "
              f"= {CFG.depth * per_layer:.3f} ms; chain {CFG.depth} x "
              f"{chain['ms']:.3f} ms; kernel bounds {CFG.depth} x {bound_layer:.3f} ms "
              f"= {CFG.depth * bound_layer:.3f} ms", flush=True)
        print(json.dumps({"throughput": {
            "batch": batch, "img_per_s": batch / ms * 1e3, "forward_ms": ms,
            "kernels": [{k: r[k] for k in ("name", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "max_abs_err")}
                        for r in rows]}}), flush=True)


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

    print("== phase 3: main path (cli, ViT-B/16, bf16, flash)", flush=True)
    counts, engine = main_path(dev)

    print("== phase 4: throughput", flush=True)
    with torch.inference_mode():
        throughput(engine, dev)

    record = {"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["module"]],
         "replaces": REPLACES[r["module"]], "launches": counts[r["module"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for r in rows]}
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

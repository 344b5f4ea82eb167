"""Perf PROBE: training-step time per batch across backward implementations.

Counterpart of ``scripts/bench_train.py``, on the port's
``parallel/spmd.make_train_step`` (SGD, bf16 compute), one device:

  xla    — per-op PyTorch forward, autograd backward
  flash  — the packed-attention kernel in both directions
  fused  — the encoder layer's forward chain and its fused backward stages
           (rematerializing; x is the only residual a layer)

Usage: python -m vit_with_opencl_tpu_torch.scripts.bench_train [config]
       [batch] [iters] [impls]

PARAM_DTYPE=bf16 keeps the master weights in bf16. ACCUM=A splits the batch
into A microbatches. UNROLL is accepted and has no effect: the port's
encoder is a Python loop, with nothing to unroll. Not ported yet (each
raises ``NotImplementedError``): the ``*_split*`` routes (ROADMAP Queue 1
item 8, ``parallel/split_step``), TUNE=1 (item 6, the autotune cache) and
AUG=1 (item 3, the augment pipeline). An out-of-memory step is a printed
data point, not a failure.
"""
from __future__ import annotations

import os
import sys
import time

import torch

from .. import get_config
from ..engine import resolve_device
from ..models import vit
from ..parallel import spmd


def _refuse_unported_options() -> None:
    if os.environ.get("TUNE", "0") == "1":
        raise NotImplementedError(
            "TUNE=1 needs the autotune cache, which the port does not have "
            "yet (ROADMAP Queue 1 item 6)")
    if os.environ.get("AUG", "0") == "1":
        raise NotImplementedError(
            "AUG=1 needs the augment pipeline, which the port does not have "
            "yet (ROADMAP Queue 1 item 3)")


def main(argv=None, device=None) -> dict:
    """Run the probe; returns {impl: {"ms": ms a step, "loss": last loss}}
    for every route that ran."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 128
    iters = int(argv[2]) if len(argv) > 2 else 20
    impls = tuple(argv[3].split(",")) if len(argv) > 3 else (
        "xla", "flash", "fused")
    _refuse_unported_options()
    for impl in impls:
        if impl.startswith(("fused_split", "flash_split", "staged_split")):
            raise NotImplementedError(
                f"route {impl!r} runs parallel/split_step, which the port "
                "does not have yet (ROADMAP Queue 1 item 8)")
    dev = resolve_device(device)
    cfg = get_config(name)

    pdt = (torch.bfloat16 if os.environ.get("PARAM_DTYPE", "f32")
           in ("bf16", "bfloat16") else torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((batch, cfg.in_chans, cfg.img_size, cfg.img_size),
                         generator=gen, device=dev)
    labels = torch.arange(batch, device=dev) % cfg.num_classes

    # Forward-only FLOPs per image; training ~3x (fwd + 2x bwd GEMMs), the
    # rematerializing fused backward recomputes the forward: ~4x.
    gflop_fwd = cfg.flops_per_image / 1e9
    accum = int(os.environ.get("ACCUM", "1"))
    unroll = int(os.environ.get("UNROLL", "1"))
    results = {}
    for impl in impls:
        step = spmd.make_train_step(cfg, device=dev, lr=1e-4,
                                    compute_dtype=torch.bfloat16,
                                    attention_impl=impl, grad_accum=accum,
                                    scan_unroll=unroll)
        # The step updates the weights in place: each route starts afresh.
        params = vit.cheap_stacked_params(cfg, param_dtype=pdt, device=dev)
        try:
            t0 = time.perf_counter()
            p, loss = step(params, images, labels)
            float(loss)
            compile_s = time.perf_counter() - t0  # the kernels' build, warm-up
            # Warm steady state.
            p, loss = step(p, images, labels)
            float(loss)
            t0 = time.perf_counter()
            for _ in range(iters):
                p, loss = step(p, images, labels)
            loss = float(loss)
        except torch.cuda.OutOfMemoryError as e:  # OOM is a DATA POINT here:
            # the per-op backward keeps [B, H, T, T] fp32 score tensors that
            # the flash/fused backward kernels never allocate.
            msg = str(e).split("\n")[0][:140]
            print(f"{impl:6s}: FAILED {type(e).__name__}: {msg}")
            continue
        ms = (time.perf_counter() - t0) / iters * 1e3
        results[impl] = {"ms": ms, "loss": loss}
        print(f"{impl:6s}: {ms:8.2f} ms/step  "
              f"({batch / ms * 1e3:7.0f} img/s, loss {loss:.4f}, "
              f"3x-fwd TF/s {3 * gflop_fwd * batch / ms:6.1f}, "
              f"compile {compile_s:.0f}s)")

    base = results.get("xla")
    for impl in ("flash", "fused"):
        if base and impl in results:
            print(f"{impl} vs xla: "
                  f"{(base['ms'] / results[impl]['ms'] - 1) * 100:+.1f}%")
    return results


if __name__ == "__main__":
    main()

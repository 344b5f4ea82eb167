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
encoder is a Python loop, with nothing to unroll. TUNE=1 consults the
autotune cache's ``train`` entry at the batch (falling back to the bf16
inference entry), the lookup ``Trainer(batch_size=)`` makes, and hands it
to every step; TUNE=0 (the default) runs the shipped defaults. Not ported
yet (each raises ``NotImplementedError``): the ``*_split*`` routes
(``parallel/split_step``). An out-of-memory step is a printed data point,
not a failure.

AUG=1 adds the augment probe: the host pipeline's img/s
(``augment.augmented_dataset``, Mixup/CutMix on the host and left to the
card, one producer and a fork pool of the host's cores), the on-card
pipeline's ms a batch (``augment_device.device_augment`` and
``augment.device_mixup_cutmix``), and for each measured route whether the
host pipeline feeds the step or starves it.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import augment, augment_device, get_config
from ..engine import resolve_device
from ..models import vit
from ..parallel import spmd


def main(argv=None, device=None) -> dict:
    """Run the probe; returns {impl: {"ms": ms a step, "loss": last loss}}
    for every route that ran, and with AUG=1 the augment probe's numbers
    under "augment"."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 128
    iters = int(argv[2]) if len(argv) > 2 else 20
    impls = tuple(argv[3].split(",")) if len(argv) > 3 else (
        "xla", "flash", "fused")
    for impl in impls:
        if impl.startswith(("fused_split", "flash_split", "staged_split")):
            raise NotImplementedError(
                f"route {impl!r} runs parallel/split_step, which the port "
                "does not have yet")
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
    tuning = None
    if os.environ.get("TUNE", "0") == "1":
        from ..perf import autotune

        tuning = autotune.lookup(cfg, batch, torch.bfloat16, quant="train",
                                 device=dev)
        print(f"tuning: { {k: v for k, v in tuning.items() if not k.endswith('_ms')} }")
    results = {}
    for impl in impls:
        step = spmd.make_train_step(cfg, device=dev, lr=1e-4,
                                    compute_dtype=torch.bfloat16,
                                    attention_impl=impl, grad_accum=accum,
                                    scan_unroll=unroll, tuning=tuning)
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
    if os.environ.get("AUG", "0") == "1":
        results["augment"] = _augment_probe(
            cfg, batch, {k: v["ms"] for k, v in results.items()}, dev)
    return results


def _host_rate(images, labels, batch: int, cfg, mix: str, workers: int) -> float:
    """img/s of ``augmented_dataset``: one batch to warm up (first-touch
    page faults, the pool's start), then 4 batches on the host clock."""
    it = augment.augmented_dataset(images, labels, batch, cfg.num_classes,
                                   img_size=cfg.img_size, epochs=None, seed=0,
                                   mix=mix, workers=workers)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(4):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        it.close()  # terminates the pool
    print(f"augment(mix={mix:6s}, workers={workers}): {dt / 4 * 1e3:8.2f} "
          f"ms/batch ({4 * batch / dt:7.0f} img/s host)")
    return 4 * batch / dt


def _device_ms(fn, dev, reps: int = 5) -> float:
    """ms a call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _augment_probe(cfg, batch: int, step_ms: dict, dev) -> dict:
    """The host pipeline's img/s against each measured step rate (does one
    producer, or a pool of the host's cores, feed the card?), and the
    on-card pipeline's ms a batch."""
    rng = np.random.default_rng(0)
    # Sources at the 256-for-224 size an ImageNet loader hands the
    # transform stage.
    src = round(cfg.img_size * 256 / 224)
    n_src = max(batch, 64)
    images = rng.integers(0, 256, (n_src, src, src, 3), dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, n_src)
    print(f"augment probe: {n_src} seeded {src}x{src} uint8 images, batch "
          f"{batch}, _resize backend {augment.resize_backend()}, device "
          f"{dev}{' (' + torch.cuda.get_device_name(dev) + ')' if dev.type == 'cuda' else ''}")
    where = "the card" if dev.type == "cuda" else "the CPU"
    rates = {mix: _host_rate(images, labels, batch, cfg, mix, 1)
             for mix in ("host", "device")}
    cores = os.cpu_count() or 1
    pool_rate = (_host_rate(images, labels, batch, cfg, "device", cores)
                 if cores > 1 else rates["device"])

    raw = torch.from_numpy(images[:batch]).to(dev)
    lbl = torch.from_numpy(labels[:batch]).to(dev)
    gen = torch.Generator()
    aug_ms = _device_ms(lambda: augment_device.device_augment(
        raw, gen, img_size=cfg.img_size), dev)
    x = augment_device.device_augment(raw, gen, img_size=cfg.img_size)
    mix_ms = _device_ms(lambda: augment.device_mixup_cutmix(
        gen, x, lbl, cfg.num_classes), dev)
    print(f"device_augment: {aug_ms:8.2f} ms/batch, device_mixup_cutmix: "
          f"{mix_ms:6.3f} ms/batch")
    for impl, ms in step_ms.items():
        step_rate = batch / ms * 1e3
        for what, rate in (("1 producer", rates["device"]),
                           (f"{cores} workers", pool_rate)):
            margin = rate / step_rate
            need = int(np.ceil(step_rate / rates["device"]))
            verdict = f"feeds {where}" if margin >= 1.0 else (
                f"STARVES {where}: needs about {need} producer processes "
                f"(augmented_dataset(workers=N)); this host has {cores} "
                f"core{'s' if cores != 1 else ''}")
            print(f"  vs {impl:6s} ({step_rate:7.0f} img/s): host pipeline, "
                  f"{what}: {margin:5.2f}x ({verdict})")
        print(f"  vs {impl:6s}: the pipeline on {where} adds "
              f"{(aug_ms + mix_ms) / ms * 100:.1f}% to the step")
    return {"host_img_per_s": rates, "pool_img_per_s": pool_rate,
            "workers": cores, "device_augment_ms": aug_ms,
            "device_mixup_ms": mix_ms}


if __name__ == "__main__":
    main()

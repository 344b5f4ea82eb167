"""DeiT-recipe smoke: the whole training recipe on the card.

Counterpart of ``scripts/recipe_smoke.py``:

    raw uint8 loader (augment_device.raw_batches)
      → RandomResizedCrop + flip + RandAugment + normalize on the card
        (augment_device.device_augment)
      → Mixup/CutMix to soft labels on the card (augment.device_mixup_cutmix)
      → AdamW step (bf16 compute; the ``fused`` route by default)
      → EMA shadow weights → the EMA export

and its cost, twice: (a) end to end through ``Trainer.fit`` (the host
loader, the uint8 upload, the pipeline and the step) against the same
Trainer on pre-normalized fp32 batches; (b) with the batches staged on the
card once and the steps chained, which leaves the pipeline's own price on
the card: ms a step with and without it, and its share of the step.

Usage: python -m vit_with_opencl_tpu_torch.scripts.recipe_smoke [config]
       [batch] [steps] [impl]
"""
from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch

from .. import data, get_config
from ..augment_device import raw_batches
from ..engine import resolve_device
from ..optim import tree_leaves
from ..train import Trainer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_fit(tr: Trainer, batches, steps: int, dev) -> float:
    """ms a step of ``steps`` more steps of ``tr.fit`` (host clock, the card
    synchronised at both ends)."""
    _sync(dev)
    t0 = time.perf_counter()
    tr.fit(batches, steps=tr.step_idx + steps)
    _sync(dev)
    return (time.perf_counter() - t0) / steps * 1e3


def _chained(tr: Trainer, images, labels, steps: int, dev,
             pipeline: bool) -> float:
    """ms a step of ``steps`` chained steps (and EMA updates) of ``tr`` on
    one batch already on the card, through the input pipeline or not."""
    def run(n):
        for i in range(n):
            x, y = (tr._prep(images, labels, tr.step_idx + i) if pipeline
                    else (images, labels))
            tr.params, tr.opt_state, _ = tr._step(tr.params, tr.opt_state, x, y)
            tr._ema_update()

    run(2)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    run(steps)
    _sync(dev)
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None, device=None) -> dict:
    """Run the smoke; returns its numbers (ms a step end to end and chained,
    with and without the pipeline, the pipeline's share, the last loss and
    the EMA export's file count)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 128
    steps = int(argv[2]) if len(argv) > 2 else 10
    impl = argv[3] if len(argv) > 3 else "fused"
    dev = resolve_device(device)
    cfg = get_config(name)

    rng = np.random.default_rng(0)
    src = round(cfg.img_size * 256 / 224)  # the 256-for-224 source size
    n = batch * 2
    raw = rng.integers(0, 256, (n, src, src, 3), dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, n)
    common = dict(device=dev, lr=1e-3, optimizer="adamw",
                  compute_dtype=torch.bfloat16, attention_impl=impl,
                  ema_decay=0.999, log_every=0)

    where = "the card" if dev.type == "cuda" else "the CPU"
    # (a) the recipe end to end: on-card augment + mixup + EMA.
    tr = Trainer(cfg, device_augment={}, mixup={"prob": 1.0}, **common)
    t0 = time.perf_counter()
    tr.fit(raw_batches(raw, labels, batch, epochs=None, seed=1), steps=1)
    _sync(dev)
    print(f"recipe first step (kernel build, warm-up): "
          f"{time.perf_counter() - t0:.1f} s (loss {tr.last_loss:.4f})")
    ms_recipe = _timed_fit(tr, raw_batches(raw, labels, batch, epochs=None,
                                           seed=2), steps, dev)
    print(f"recipe step (augment + mixup + EMA on {where}): {ms_recipe:8.2f} "
          f"ms/step ({batch / ms_recipe * 1e3:6.0f} img/s, loss "
          f"{tr.last_loss:.4f})")
    if not np.isfinite(tr.last_loss):
        raise FloatingPointError(f"recipe loss {tr.last_loss}")
    ema = tree_leaves(tr.ema_params)
    if not all(bool(torch.isfinite(t).all()) for t in ema):
        raise FloatingPointError("the EMA shadow holds a non-finite value")
    with tempfile.TemporaryDirectory() as tmp:
        files = tr.export_reference(tmp, use_ema=True)
    print(f"EMA shadow: {len(ema)} leaves, fp32="
          f"{all(t.dtype == torch.float32 for t in ema)}; exported "
          f"{len(files)} weight files")

    pre = rng.normal(0, 1, (n, cfg.in_chans, cfg.img_size, cfg.img_size)
                     ).astype(np.float32)
    tb = Trainer(cfg, **common)
    tb.fit(data.memory_dataset(pre, labels, batch, epochs=None, seed=1),
           steps=1)
    ms_bare = _timed_fit(tb, data.memory_dataset(pre, labels, batch,
                                                 epochs=None, seed=2),
                         steps, dev)
    print(f"bare step (pre-normalized fp32 in):           {ms_bare:8.2f} "
          f"ms/step ({batch / ms_bare * 1e3:6.0f} img/s)")
    print(f"end-to-end delta (uint8 ships {batch * src * src * 3 / 2**20:.1f} "
          f"MB a batch, fp32 {batch * cfg.in_chans * cfg.img_size**2 * 4 / 2**20:.1f}"
          f" MB): {ms_recipe - ms_bare:+.2f} ms/step "
          f"({(ms_recipe / ms_bare - 1) * 100:+.1f}%)")

    # (b) batches staged on the card once, the steps chained.
    lbl = torch.from_numpy(labels[:batch]).to(dev)
    ms_r = _chained(tr, torch.from_numpy(raw[:batch]).to(dev), lbl, steps, dev,
                    pipeline=True)
    ms_b = _chained(tb, torch.from_numpy(pre[:batch]).to(dev), lbl, steps, dev,
                    pipeline=False)
    share = (ms_r - ms_b) / ms_r
    print(f"staged recipe step (augment + mixup + EMA): {ms_r:8.2f} ms/step "
          f"({batch / ms_r * 1e3:6.0f} img/s)")
    print(f"staged bare step (fp32 in):                 {ms_b:8.2f} ms/step "
          f"({batch / ms_b * 1e3:6.0f} img/s)")
    print(f"the pipeline on {where}: {ms_r - ms_b:+.2f} ms/step, "
          f"{share * 100:.1f}% of the recipe step, "
          f"{(ms_r - ms_b) / batch * 1e3:+.0f} us/img")
    return {"recipe_ms": ms_recipe, "bare_ms": ms_bare, "staged_recipe_ms": ms_r,
            "staged_bare_ms": ms_b, "pipeline_share": share,
            "loss": tr.last_loss, "export_files": len(files)}


if __name__ == "__main__":
    main()

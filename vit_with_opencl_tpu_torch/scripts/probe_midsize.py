"""Perf probe: mid-size configs (D = 384-512), the per-op path against the
chains of ``ops/fused_block``.

Counterpart of ``scripts/probe_midsize.py``: times the ``flash`` route's
bf16 forward several ways, each by patching ``fused_block.supports``,
``supports_stack`` and ``fused_encoder_layer`` (``models/vit.encoder``
looks them up at every call; all three are restored afterwards):

  * ``perop``   the packed attention kernel and plain GEMMs (``supports``
                and ``supports_stack`` forced False);
  * ``fused``   the per-layer chain (``supports`` True, the stack off);
  * ``fusedflat`` the per-layer slot through the stack's one-layer form
                (``fused_encoder_layer_flat``);
  * ``int8perop``, ``int8fused``: the same two on int8 weights (weight-only
                int8, quantized on the device);
  * ``group2``-``group4``: layer groups of that size
                (``kernels["fused_group_size"]``);
  * ``stack``   the whole-encoder chain (``supports_stack`` True).

``fusedipc1`` and ``fusedipc4`` (images per grid cell) have no counterpart:
the Hopper chain has no grid cells of images; they are refused, printed as
FAILED like any variant that fails, and the run goes on. Each variant
prints ms/batch, img/s and TFLOP/s on ``config.flops_per_image``: wall
time of ``iters`` forwards after a warm-up, the card synchronised around
them.

Usage: python -m vit_with_opencl_tpu_torch.scripts.probe_midsize [config]
       [batch] [iters] [variants]
  variants: comma list from the above; default perop,fused,stack
  config 'd512' is a synthetic D=512/depth-12/8-head preset.
"""
from __future__ import annotations

import sys
import time

import torch

from ..engine import resolve_device
from ..models import quant as quantlib
from ..models import vit
from ..ops import fused_block
from .probe_tiny_bound import config_for, seeded_images


def _true(*a, **k):
    return True


def _false(*a, **k):
    return False


def _flat_layer(x, lp, config, *, w8a8=False):
    """``fused_encoder_layer_flat`` in the per-layer slot (which passes
    ``w8a8``; the flat form has no W8A8)."""
    if w8a8:
        raise NotImplementedError("fusedflat: the stack's one-layer form has no W8A8")
    return fused_block.fused_encoder_layer_flat(x, lp, config)


# label -> (supports, supports_stack)
VARIANTS = {
    "perop": (_false, _false),
    "fused": (_true, _false),
    "fusedflat": (_true, _false),
    "int8perop": (_false, _false),
    "int8fused": (_true, _false),
    "fusedipc1": (_true, _false),
    "fusedipc4": (_true, _false),
    "group2": (_true, _false),
    "group3": (_true, _false),
    "group4": (_true, _false),
    "stack": (_false, _true),
}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_forward(images, params, cfg, iters, group_size=None) -> float:
    """Seconds a forward, the mean of ``iters`` after one warm-up."""
    kern = vit.resolve_kernels("flash")
    if group_size:
        kern["fused_group_size"] = group_size
    dev = images.device
    with torch.inference_mode():
        vit.forward(images, params, cfg, compute_dtype=torch.bfloat16, kernels=kern)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            vit.forward(images, params, cfg, compute_dtype=torch.bfloat16, kernels=kern)
        _sync(dev)
    return (time.perf_counter() - t0) / iters


def main(argv=None, device=None) -> dict:
    """Print each variant's line; returns {label: seconds a forward, or None
    where it failed}."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_s_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 512
    iters = int(argv[2]) if len(argv) > 2 else 20
    wanted = argv[3].split(",") if len(argv) > 3 else ["perop", "fused", "stack"]
    unknown = [w for w in wanted if w not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown} (use {', '.join(VARIANTS)})")
    dev = resolve_device(device)
    cfg = config_for(name)
    params = vit.cheap_stacked_params(cfg, param_dtype=torch.bfloat16, device=dev)
    qparams = None
    images = seeded_images(cfg, batch, dev)
    flops = cfg.flops_per_image * batch

    real_sup, real_stk = fused_block.supports, fused_block.supports_stack
    real_layer = fused_block.fused_encoder_layer
    print(f"{cfg.name} bs{batch} ({flops / batch / 1e9:.1f} GFLOP/img)")
    results = {}
    for label in wanted:
        sup, stk = VARIANTS[label]
        fused_block.supports, fused_block.supports_stack = sup, stk
        fused_block.fused_encoder_layer = (_flat_layer if label == "fusedflat"
                                           else real_layer)
        gs = int(label[5:]) if label.startswith("group") else None
        p_run = params
        try:
            if label.startswith("fusedipc"):
                raise NotImplementedError(
                    "images per grid cell is a knob of the TPU kernel's grid; "
                    "the Hopper chain has no grid cells of images")
            if label.startswith("int8"):
                if qparams is None:
                    qparams = quantlib.quantize_stacked_params_device(params, cfg)
                p_run = qparams
            dt = timed_forward(images, p_run, cfg, iters, group_size=gs)
        except Exception as e:  # noqa: BLE001 — the probe reports, it does not die
            print(f"  {label:6s}: FAILED {type(e).__name__}: {e}"[:200])
            results[label] = None
            continue
        finally:
            fused_block.supports, fused_block.supports_stack = real_sup, real_stk
            fused_block.fused_encoder_layer = real_layer
        results[label] = dt
        print(f"  {label:6s}: {dt * 1e3:8.2f} ms/batch  "
              f"{batch / dt:9.0f} img/s  {flops / dt / 1e12:6.1f} TF/s")
    return results


if __name__ == "__main__":
    main()

"""Sustained-load soak: N consecutive batches through the forward.

Counterpart of ``scripts/soak.py``. Reports per-window throughput (drift
detection), min/max window, and a finite-output check at the end. Mirrors
the reference's long-run usage (its per-picture clock() loop,
ViT_opencl.c:964) at production batch size. The weights are
``vit.cheap_stacked_params`` made on the device (quantized there for the
int8 modes); the forward is the ``flash`` route's kernels in bf16, timed on
the host clock with the device synchronised at each window's end.

Usage: python -m vit_with_opencl_tpu_torch.scripts.soak [config] [batch]
       [batches] [window] [quant]
(quant: "int8-w8a8" / "int8" soaks the quantized production path)
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import get_config
from ..engine import resolve_device
from ..models import quant as quantlib
from ..models import vit


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def main(argv=None, device=None) -> dict:
    """Run the soak; returns the windows' img/s and the finite check."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 256
    total = int(argv[2]) if len(argv) > 2 else 300
    window = int(argv[3]) if len(argv) > 3 else 50
    quant = argv[4] if len(argv) > 4 else None
    if quant not in (None, "int8", "int8-w8a8"):
        raise SystemExit(f"unknown quant mode {quant!r} "
                         "(use int8 or int8-w8a8)")
    dev = resolve_device(device)
    cfg = get_config(name)
    params = vit.cheap_stacked_params(cfg, device=dev)
    if quant:
        params = quantlib.quantize_stacked_params_device(params, cfg)
        if quant == "int8-w8a8":
            params = quantlib.w8a8_layout(params)  # the W8A8 GEMM's layout
    r = np.random.default_rng(0)
    images = torch.from_numpy(
        r.standard_normal((batch, 3, cfg.img_size, cfg.img_size)) * 0.3
    ).to(dev).to(torch.bfloat16)
    kern = vit.resolve_kernels("flash", w8a8=quant == "int8-w8a8")

    def fwd(im, p):
        return vit.forward(im, p, cfg, compute_dtype=torch.bfloat16,
                           kernels=kern)

    out = fwd(images, params)
    _sync(dev)  # warm (builds the kernels at first use)

    rates = []
    done = 0
    while done < total:
        n = min(window, total - done)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fwd(images, params)
        _sync(dev)
        dt = time.perf_counter() - t0
        rates.append(n * batch / dt)
        done += n
        print(f"  window {len(rates):3d}: {rates[-1]:9.0f} img/s")
    finite = bool(torch.isfinite(out).all())
    drift = (max(rates) - min(rates)) / max(rates) * 100
    print(f"soak: {total} batches x {batch} = {total * batch} images; "
          f"mean {np.mean(rates):.0f} img/s, min {min(rates):.0f}, "
          f"max {max(rates):.0f} (spread {drift:.1f}%), "
          f"finite={finite}")
    return {"rates": rates, "finite": finite}


if __name__ == "__main__":
    main()

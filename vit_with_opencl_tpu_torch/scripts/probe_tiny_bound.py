"""Perf probe (not a correctness path): where does a forward's time go?

Counterpart of ``scripts/probe_tiny_bound.py``: a thin CLI over
``perf.profiler.attribute_forward``, substitution attribution of the real
``flash`` forward (identity GELU; the softmax replaced by a constant weight
a key), plus the GEMM skeleton's implied TFLOP/s on the forward's FLOP
count, beside the card's dense peaks (989 TFLOP/s bf16, 1979 TOP/s int8:
``perf.profiler.PEAK_BF16_TFLOPS`` and ``PEAK_INT8_TOPS``).

Usage: python -m vit_with_opencl_tpu_torch.scripts.probe_tiny_bound [batch]
       [iters] [config] [quant]

``quant=int8-w8a8`` attributes the W8A8 forward: the params are quantized
on the device and stored in the W8A8 GEMM's layout
(``models/quant.w8a8_layout``), the GEMMs run int8, and the report adds the
row quantizes' share (the absmax, divide and rounding, isolated by a cheap
convert with a scale of 1.0). The skeleton line is then the int8 GEMMs'
bound. ``int8`` quantizes the weights alone. The config ``d512`` is the JAX
script's synthetic D = 512, depth-12, 8-head preset. The weights are
``vit.cheap_stacked_params`` made on the device, the images seeded normal
draws times 0.3 in bf16, as in the JAX script.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import ViTConfig, get_config
from ..engine import resolve_device
from ..models import quant as quantlib
from ..models import vit
from ..perf import profiler


def config_for(name: str) -> ViTConfig:
    """A preset, or the JAX scripts' synthetic ``d512``."""
    if name == "d512":
        return ViTConfig(name="d512", embed_dim=512, depth=12, num_heads=8)
    return get_config(name)


def seeded_images(cfg: ViTConfig, batch: int, dev) -> torch.Tensor:
    r = np.random.default_rng(0)
    images = r.standard_normal((batch, 3, cfg.img_size, cfg.img_size)) * 0.3
    return torch.from_numpy(images.astype(np.float32)).to(dev, torch.bfloat16)


def main(argv=None, device=None) -> dict:
    """Print the attribution; returns ``attribute_forward``'s dict with the
    skeleton's implied TFLOP/s (``skeleton_tflops``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    batch = int(argv[0]) if len(argv) > 0 else 1024
    iters = int(argv[1]) if len(argv) > 1 else 20
    name = argv[2] if len(argv) > 2 else "vit_tiny_16_224"
    quant = argv[3] if len(argv) > 3 else None
    if quant not in (None, "int8", "int8-w8a8"):
        raise SystemExit(f"unknown quant mode {quant!r} "
                         "(use int8 or int8-w8a8)")
    dev = resolve_device(device)
    cfg = config_for(name)
    params = vit.cheap_stacked_params(cfg, param_dtype=torch.bfloat16, device=dev)
    if quant:
        params = quantlib.quantize_stacked_params_device(params, cfg)
        if quant == "int8-w8a8":
            params = quantlib.w8a8_layout(params)  # the W8A8 GEMM's layout
    images = seeded_images(cfg, batch, dev)

    a = profiler.attribute_forward(cfg, params, images, iters=iters, quant=quant)
    print(f"baseline          : {a['total_ms']:8.2f} ms/batch  "
          f"{batch / a['total_ms'] * 1e3:9.0f} img/s")
    print(f"GELU share        : {a['gelu_share'] * 100:5.1f}%  "
          f"({a['gelu_ms']:.2f} ms)")
    print(f"softmax share     : {a['softmax_share'] * 100:5.1f}%  "
          f"({a['softmax_ms']:.2f} ms)")
    if "quantize_share" in a:
        print(f"quantize share    : {a['quantize_share'] * 100:5.1f}%  "
              f"({a['quantize_ms']:.2f} ms)")
    print(f"GEMM skeleton     : {a['gemm_skeleton_ms']:8.2f} ms/batch  "
          f"(VPU total share {a['vpu_share'] * 100:5.1f}%)")
    flops = cfg.flops_per_image * batch
    tflops = flops / (a["gemm_skeleton_ms"] / 1e3) / 1e12
    print(f"skeleton implies  : {tflops:6.1f} TF/s "
          f"effective on the same FLOP count")
    if dev.type == "cuda":
        kind, peak = (("int8", profiler.PEAK_INT8_TOPS["h100"])
                      if quant == "int8-w8a8"
                      else ("bf16", profiler.PEAK_BF16_TFLOPS["h100"]))
        print(f"card peaks        : {profiler.PEAK_BF16_TFLOPS['h100']:.0f} TFLOP/s "
              f"dense bf16, {profiler.PEAK_INT8_TOPS['h100']:.0f} TOP/s dense int8 "
              f"({torch.cuda.get_device_name(dev)}); the skeleton at "
              f"{tflops / peak:.3f} of the {kind} peak")
    return dict(a, skeleton_tflops=tflops)


if __name__ == "__main__":
    main()

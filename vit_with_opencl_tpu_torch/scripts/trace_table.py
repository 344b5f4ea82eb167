"""Print the trace-derived per-kernel DEVICE-time table for a config.

Counterpart of ``scripts/trace_table.py``: the equivalent of the
reference's (disabled) CL_PROFILING event report (ViT_opencl.c:988-1048):
runs the ``flash`` route's bf16 forward under ``torch.profiler`` and
aggregates the card's kernel spans (``perf/kernel_trace.py``). The weights
are ``vit.cheap_stacked_params`` made on the device (quantized there for the
int8 modes), the images seeded normal draws.

Usage: python -m vit_with_opencl_tpu_torch.scripts.trace_table [config]
       [batch] [iters] [top] [quant]
(quant: "int8-w8a8" / "int8" traces the quantized production path)
"""
from __future__ import annotations

import sys

import torch

from .. import get_config
from ..engine import resolve_device
from ..models import quant as quantlib
from ..models import vit
from ..perf import kernel_trace


def main(argv=None, device=None) -> list:
    """Print the table; returns its rows (``kernel_trace.KernelSpan``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 256
    iters = int(argv[2]) if len(argv) > 2 else 5
    top = int(argv[3]) if len(argv) > 3 else 15
    quant = argv[4] if len(argv) > 4 else None
    if quant not in (None, "int8", "int8-w8a8"):
        raise SystemExit(f"unknown quant mode {quant!r} "
                         "(use int8 or int8-w8a8)")
    dev = resolve_device(device)
    cfg = get_config(name)
    params = vit.cheap_stacked_params(cfg, param_dtype=torch.bfloat16,
                                      device=dev)
    if quant:
        params = quantlib.quantize_stacked_params_device(params, cfg)
        if quant == "int8-w8a8":
            params = quantlib.w8a8_layout(params)  # the W8A8 GEMM's layout
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((batch, cfg.in_chans, cfg.img_size, cfg.img_size),
                         generator=gen, device=dev)

    kernels = vit.resolve_kernels("flash", w8a8=quant == "int8-w8a8")

    @torch.inference_mode()
    def fwd(im, p):
        if cfg.head_type == "none":
            # Bare tower (CLIP): trace feature extraction.
            return vit.forward_features(im, p, cfg, compute_dtype=torch.bfloat16,
                                        kernels=kernels)[:, 0]
        return vit.forward(im, p, cfg, compute_dtype=torch.bfloat16,
                           kernels=kernels)

    table = kernel_trace.device_kernel_table(fwd, (images, params),
                                             iters=iters, top=top)
    print(kernel_trace.format_kernel_table(table, iters=iters))
    return table


if __name__ == "__main__":
    main()

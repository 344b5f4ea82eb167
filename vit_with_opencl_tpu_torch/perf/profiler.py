"""Per-op profiling and throughput reporting on the card.

Counterpart of ``vit_with_opencl_tpu/perf/profiler.py``: the reference's
commented-out event-profiling scaffold (ViT_opencl.c:988-1048) restored for
the port.

  * ``profile_ops``: times each pipeline stage (embed, LN, QKV, attention
    core, out-proj, MLP, head, softmax) on its own and reports the
    reference's totals/averages table shape (``format_profile``, the same
    text as JAX's for the same stages);
  * ``trace``: a ``torch.profiler`` context that writes a Chrome trace;
  * ``throughput_report``: images/sec, achieved TFLOP/s and MFU against the
    card's published dense bf16 peak.

Times on the card come from CUDA events around queued calls; on CPU tensors
from ``perf_counter`` (a CPU time, never a device metric).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import ViTConfig
from ..models import vit
from .kernel_trace import tensors_in

# Dense bf16 tensor-core peaks, TFLOP/s (NVIDIA's data sheet: the H100 SXM).
PEAK_BF16_TFLOPS = {"h100": 989.0}


@dataclasses.dataclass
class OpProfile:
    """One pipeline stage's timing: per-call ms (for the whole batch) and
    how many times the op runs per image's forward pass."""

    name: str
    calls_per_image: int
    per_call_ms: float

    @property
    def per_image_total_ms(self) -> float:
        """Total ms this op contributes to one batch's forward pass."""
        return self.per_call_ms * self.calls_per_image


def _time_op(fn: Callable, args, iters: int) -> float:
    """Median of 3 timings (ms) of ``iters`` queued calls after a warm-up:
    CUDA events on the card, ``perf_counter`` on the CPU."""
    on_card = any(t.is_cuda for t in tensors_in(args))
    fn(*args)  # warm-up (and the kernels' build)
    samples = []
    for _ in range(3):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def _first_layer(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Layer 0's slice of the stacked weights (int8 dicts too)."""
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in layers.items()}


def profile_ops(
    config: ViTConfig,
    params: Dict[str, Any],
    images: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attention_impl: str = "xla",
    iters: int = 10,
) -> List[OpProfile]:
    """Stage-by-stage timing of the forward pipeline (each stage on its own,
    batch taken from ``images``), on the device ``images`` lie on; the
    stages, their names and calls per image are JAX's."""
    kernels = vit.resolve_kernels(attention_impl)
    b = images.shape[0]
    t, nh, hd = config.num_tokens, config.num_heads, config.head_dim
    lp0 = _first_layer(params["layers"])
    stages: List[OpProfile] = []

    def add(name, fn, args, calls_per_image: int):
        ms = _time_op(fn, args, iters)
        stages.append(OpProfile(name, calls_per_image, ms / iters))

    with torch.no_grad():
        x = vit.embed(images, params, config, compute_dtype)
        qkv = (kernels["matmul"](x, lp0["qkv_w"], lp0["qkv_b"])
               .reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4))
        # The generic slot on the split heads (views of the GEMM output), as
        # JAX's computes it before timing.
        kernels["attention"](qkv[0], qkv[1], qkv[2], config)
        hid = kernels["matmul_gelu"](x, lp0["fc1_w"], lp0["fc1_b"], config)

        L = config.depth
        add("patch_embed(+cls+pos)",
            lambda im, p: vit.embed(im, p, config, compute_dtype),
            (images, params), 1)
        add("layer_norm",
            lambda h, lp: kernels["layer_norm"](h, lp["ln1_w"], lp["ln1_b"],
                                                config.eps),
            (x, lp0), 2 * L + 1)
        add("qkv_proj",
            lambda h, lp: kernels["matmul"](h, lp["qkv_w"], lp["qkv_b"]),
            (x, lp0), L)
        if "attention_packed" in kernels:
            # Time the packed kernel the engine actually uses.
            qkv_packed = kernels["matmul"](x, lp0["qkv_w"], lp0["qkv_b"])
            add("attention_core(packed)",
                lambda qk: kernels["attention_packed"](qk, config),
                (qkv_packed,), L)
        else:
            add("attention_core",
                lambda q: kernels["attention"](q[0], q[1], q[2], config),
                (qkv,), L)
        add("out_proj",
            lambda h, lp: kernels["matmul"](h, lp["out_w"], lp["out_b"]),
            (x, lp0), L)
        add("mlp_fc1_gelu",
            lambda h, lp: kernels["matmul_gelu"](h, lp["fc1_w"], lp["fc1_b"],
                                                 config),
            (x, lp0), L)
        add("mlp_fc2",
            lambda h, lp: kernels["matmul"](h, lp["fc2_w"], lp["fc2_b"]),
            (hid, lp0), L)
        if config.head_type != "none":
            cls = x[:, 0]
            add("head+softmax",
                lambda c, p: torch.softmax(
                    c.to(p["head_w"].dtype).float() @ p["head_w"].float()
                    + p["head_b"], dim=-1),
                (cls, params), 1)
    return stages


def format_profile(stages: List[OpProfile], batch: int) -> str:
    """The reference reporter's shape (per-op totals/averages). Per-call
    timings cover the whole batch; the total column is ms per batch."""
    lines = [
        f"{'op':<24}{'calls/img':>10}{'ms/call':>12}{'ms/batch total':>15}",
        "-" * 61,
    ]
    total = 0.0
    for s in stages:
        total += s.per_image_total_ms
        lines.append(
            f"{s.name:<24}{s.calls_per_image:>10}{s.per_call_ms:>12.3f}"
            f"{s.per_image_total_ms:>15.3f}"
        )
    lines.append("-" * 61)
    lines.append(f"{'sum (batch of ' + str(batch) + ')':<24}{'':>10}{'':>12}"
                 f"{total:>15.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device: str = "cuda"):
    """``torch.profiler`` around a block; writes the Chrome trace
    ``trace.json`` into ``log_dir`` (a new temporary directory by default;
    view it with Perfetto or chrome://tracing) and yields that directory.
    With ``device="cuda"`` it traces the card's kernels too, and raises
    where there is no card."""
    activity = torch.profiler.ProfilerActivity
    activities = [activity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda'): no CUDA device; pass "
                               "device='cpu' to trace the host alone")
        activities.append(activity.CUDA)
    log_dir = log_dir or tempfile.mkdtemp(prefix="vit-torch-trace-")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput_report(
    config: ViTConfig,
    batch: int,
    elapsed_s: float,
    iters: int,
    *,
    gpu: str = "h100",
) -> Dict[str, float]:
    """Images/sec, GFLOP per image (``config.flops_per_image``), achieved
    TFLOP/s, MFU against the card's dense bf16 peak, and the img/s at that
    peak: JAX's keys and arithmetic."""
    if gpu not in PEAK_BF16_TFLOPS:
        raise ValueError(f"unknown gpu {gpu!r}; known: {sorted(PEAK_BF16_TFLOPS)}")
    imgs_per_sec = batch * iters / elapsed_s
    gflop = config.flops_per_image / 1e9
    achieved_tflops = imgs_per_sec * gflop / 1e3
    peak = PEAK_BF16_TFLOPS[gpu]
    return {
        "images_per_sec": imgs_per_sec,
        "gflop_per_image": gflop,
        "achieved_tflops": achieved_tflops,
        "mfu": achieved_tflops / peak,
        "roofline_images_per_sec": peak * 1e3 / gflop,
    }

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
    card's published dense bf16 peak;
  * ``attribute_forward``: substitution attribution of the real forward
    (the GELU, the softmax and, for W8A8, the row quantizes each replaced by
    a cheap stand-in that keeps every GEMM: ``kernel_substitutions``), each
    component's share the time it takes away.

Times on the card come from CUDA events around queued calls; on CPU tensors
from ``perf_counter`` (a CPU time, never a device metric).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import ViTConfig
from ..models import vit
from ..ops import substitutions
from .kernel_trace import tensors_in

# Dense bf16 tensor-core peaks, TFLOP/s, and dense int8 peaks, TOP/s
# (NVIDIA's data sheet: the H100 SXM).
PEAK_BF16_TFLOPS = {"h100": 989.0}
PEAK_INT8_TOPS = {"h100": 1979.0}


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


def attribute_forward(
    config: ViTConfig,
    params: Dict[str, Any],
    images: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    iters: int = 10,
    quant: Optional[str] = None,
) -> Dict[str, float]:
    """Substitution-based attribution of the real forward (the ``flash``
    route: the chains of ``ops/fused_block``, or the per-op path where the
    config takes it), on the device ``images`` lie on.

    ``profile_ops`` times stages alone, which counts launch and memory
    boundaries the chained forward never pays. This times the whole forward,
    then times it again with one piece of work replaced by a cheap stand-in
    that keeps every GEMM (``kernel_substitutions``: the GELU by the
    identity; the softmax by a constant weight a key, both attention
    products kept), and attributes each piece as the difference. The
    substituted forwards compute wrong outputs by construction; only their
    times are read.

    Returns ms per batch: ``total_ms``, ``gelu_ms`` (what the identity GELU
    takes away), ``softmax_ms``, ``gemm_skeleton_ms`` (both substitutions:
    the GEMMs' and the rest of the kernels' time without either), and
    ``gelu_share``, ``softmax_share`` and ``vpu_share`` (1 - skeleton /
    total), each clamped at 0 as in the JAX package. The name ``vpu_share``
    is JAX's: here it is the share of the work outside the GEMMs and
    attention products that the substitutions remove.

    ``quant="int8-w8a8"`` attributes the W8A8 forward (``params`` already
    quantized, its int8 weights stored as ``models/quant.w8a8_layout``
    stores them on the card): a third substitution replaces the per-row
    absmax quantize (``models/quant.quantize_act``, and the cheap forms of
    the row quantize kernels on the card) by a bare convert with a scale of
    1.0, and its difference is ``quantize_ms`` / ``quantize_share``; the
    skeleton then has all three.

    The route past T = 1024 (the blockwise kernel) keeps its real softmax
    under the substitution, as JAX's does, so ``softmax_share`` there is
    about 0 by construction. The substitutions are process-wide and read at
    every launch: a forward launched from another thread while this runs
    gets the stand-ins' math. A process-wide lock therefore refuses a
    second call while one runs.

    Times: CUDA events on the card, ``perf_counter`` on CPU tensors (a CPU
    time, never a device metric), by ``_time_op`` (the median of 3 timings
    of ``iters`` forwards after a warm-up), per forward.
    """
    if not _ATTRIBUTION_LOCK.acquire(blocking=False):
        raise RuntimeError(
            "attribute_forward is already running in this process; its "
            "kernel substitutions are process-global while it runs, so "
            "concurrent use would run wrong-math kernels in other forwards. "
            "Profile one model at a time.")
    try:
        w8a8 = quant == "int8-w8a8"
        kernels = vit.resolve_kernels("flash", w8a8=w8a8)

        def fwd(im, p):
            return vit.forward(im, p, config, compute_dtype=compute_dtype,
                               kernels=kernels)

        def timed(gelu_identity: bool, softmax_identity: bool,
                  quant_cheap: bool = False) -> float:
            with kernel_substitutions(gelu_identity, softmax_identity,
                                      quant_cheap):
                return _time_op(fwd, (images, params), iters) / iters

        with torch.inference_mode():
            total = timed(False, False)
            no_gelu = timed(True, False)
            no_softmax = timed(False, True)
            if w8a8:
                no_quant = timed(False, False, quant_cheap=True)
                skeleton = timed(True, True, quant_cheap=True)
            else:
                skeleton = timed(True, True)
        out = {
            "total_ms": total,
            "gelu_ms": max(0.0, total - no_gelu),
            "softmax_ms": max(0.0, total - no_softmax),
            "gemm_skeleton_ms": skeleton,
            "gelu_share": max(0.0, 1.0 - no_gelu / total),
            "softmax_share": max(0.0, 1.0 - no_softmax / total),
            "vpu_share": max(0.0, 1.0 - skeleton / total),
        }
        if w8a8:
            out["quantize_ms"] = max(0.0, total - no_quant)
            out["quantize_share"] = max(0.0, 1.0 - no_quant / total)
        return out
    finally:
        _ATTRIBUTION_LOCK.release()


# Guards attribute_forward's process-global kernel substitutions.
_ATTRIBUTION_LOCK = threading.Lock()


@contextlib.contextmanager
def kernel_substitutions(gelu_identity: bool, softmax_identity: bool,
                         quant_cheap: bool = False):
    """The probe's kernel substitutions as a context (the JAX package's, on
    the port's flags, ``ops/substitutions``): while it is active every
    forward computes wrong math through the same GEMM, attention and
    quantize launches, on the card and on CPU tensors alike; on exit the
    earlier state comes back, also when the block raises.

    - ``gelu_identity``: ``_gelu_fast`` → identity (fc1's epilogue launched
      with its ``gelu`` flag at 0; both MLP GEMMs kept);
    - ``softmax_identity``: the attention core → JAX's ``fake_head``, ``o =
      bf16(s · float32(1/T)) · v`` (the packed kernel's slab entry in its
      constant-scale form; both products kept);
    - ``quant_cheap``: ``quantize_act`` → the codes truncated toward zero
      with a scale of 1.0 (the cheap forms of the whole-row and split
      quantize kernels; the same int8 GEMMs follow).

    A card launch that has no stand-in for an active substitution raises
    ``NotImplementedError`` instead of running its real math (the packed
    kernel's key-count entry, the single-pass attention, the attention
    backward and ``fused_linear_with_gelu``), and CUDA-graph capture is
    refused while a substitution is active."""
    before = substitutions.state()
    substitutions.set_state(gelu_identity, softmax_identity, quant_cheap)
    try:
        yield
    finally:
        substitutions.set_state(*before)


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

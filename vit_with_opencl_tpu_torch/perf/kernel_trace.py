"""Trace-derived per-kernel DEVICE timing table.

Counterpart of ``vit_with_opencl_tpu/perf/kernel_trace.py``: run a function
under ``torch.profiler`` with CUDA activity, parse the Chrome trace it
exports, and aggregate the card's kernel spans into per-kernel
totals/averages (the reference's disabled reporter, ViT_opencl.c:988-1048,
fed by device event spans rather than host wall-clock).

The trace is the Chrome-trace JSON ``export_chrome_trace`` writes: complete
events (``ph == "X"``) carry ``dur`` in microseconds, and the card's kernels
are those of category ``kernel``, named by their demangled C++ signature.
On CPU tensors there are no kernels, and the table degrades to every
complete event (the host ops), as JAX's degrades on a CPU backend. On the
card a trace without kernel events raises: a profiler that cannot trace the
card (CUPTI missing) must not turn the table into host op times silently.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Callable, Iterator, List, Optional

import torch


@dataclasses.dataclass
class KernelSpan:
    """One kernel's aggregated device time across the traced window."""

    name: str
    calls: int
    total_ms: float

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.calls, 1)


def tensors_in(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor in nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for value in obj.values():
            yield from tensors_in(value)
    elif isinstance(obj, (tuple, list)):
        for value in obj:
            yield from tensors_in(value)


def _select_events(events: List[dict], on_card: bool) -> List[dict]:
    """The card's kernel spans; on CPU tensors every complete event."""
    complete = [e for e in events if e.get("ph") == "X" and e.get("dur")]
    if not on_card:
        return complete
    kernels = [e for e in complete if str(e.get("cat", "")).lower() == "kernel"]
    if not kernels:
        raise RuntimeError(
            "the profiler's trace holds no kernel events: it did not trace "
            "the card (is CUPTI available?)")
    return kernels


def device_kernel_table(
    fn: Callable,
    args: tuple,
    *,
    iters: int = 3,
    trace_dir: Optional[str] = None,
    top: Optional[int] = None,
) -> List[KernelSpan]:
    """Run ``fn(*args)`` ``iters`` times under ``torch.profiler`` and return
    per-kernel device-time totals/averages, largest first.

    Runs once OUTSIDE the traced window (builds, allocator warm-up) so the
    table reflects steady state. Totals cover all ``iters`` runs; divide by
    ``iters`` for per-invocation numbers (the call count is as traced). The
    card is traced when any tensor in ``args`` lies on it."""
    on_card = any(t.is_cuda for t in tensors_in(args))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    d = trace_dir or tempfile.mkdtemp(prefix="vit-torch-trace-")
    os.makedirs(d, exist_ok=True)
    activity = torch.profiler.ProfilerActivity
    with torch.profiler.profile(
            activities=[activity.CUDA if on_card else activity.CPU]) as prof:
        for _ in range(iters):
            fn(*args)
        sync()
    path = os.path.join(d, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])

    agg: dict = {}
    for e in _select_events(events, on_card):
        name = e.get("name", "?")
        dur_ms = float(e["dur"]) / 1e3  # trace durations are microseconds
        span = agg.get(name)
        if span is None:
            agg[name] = KernelSpan(name, 1, dur_ms)
        else:
            span.calls += 1
            span.total_ms += dur_ms
    table = sorted(agg.values(), key=lambda s: -s.total_ms)
    return table[:top] if top else table


def format_kernel_table(table: List[KernelSpan], *,
                        iters: int = 1) -> str:
    """The reference reporter's totals/averages shape
    (ViT_opencl.c:1003-1048), fed by device event spans."""
    lines = [
        f"{'kernel':<48}{'calls':>8}{'total ms':>12}{'avg ms':>10}",
        "-" * 78,
    ]
    total = 0.0
    for s in table:
        total += s.total_ms
        name = s.name if len(s.name) <= 47 else s.name[:44] + "..."
        lines.append(
            f"{name:<48}{s.calls:>8}{s.total_ms:>12.3f}{s.avg_ms:>10.4f}"
        )
    lines.append("-" * 78)
    per_run = f" ({total / iters:.3f} ms/run over {iters} runs)" \
        if iters > 1 else ""
    lines.append(f"{'device total':<48}{'':>8}{total:>12.3f}{per_run}")
    return "\n".join(lines)

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


# The two marks around the traced runs: a short spin kernel on the card
# (``torch.cuda._sleep``), an empty named range on the CPU.
_SPIN = "spin_kernel"
_MARK = "vit-kernel-trace-mark"
_MARK_CYCLES = 1000
# On the card a long spin (about 5 ms at the H100's clock) opens and closes
# the traced window, outside the marks: the tracer drops the events of the
# first and last moments of its window now and then, and a call of a few
# microseconds (the ring step alone) gave it too little to drop before its
# first mark (all three traces of one run lost a mark). A spin longer than
# _MARK_MAX_US is a guard, not a mark.
_GUARD_CYCLES = 10_000_000
_MARK_MAX_US = 100.0
# A trace that lost a mark is taken again, up to this many traces in all
# (on an H100 the ViT-Ti stack's trace at B = 16 lost its first mark in one
# run of several).
TRACE_ATTEMPTS = 3


class LostMark(RuntimeError):
    """The tracer dropped events at an edge of its window, a mark among
    them: the counts between the marks would come out short."""


def _mark(on_card: bool) -> None:
    """A mark in the trace after everything launched so far has run."""
    if on_card:
        torch.cuda.synchronize()
        torch.cuda._sleep(_MARK_CYCLES)
        torch.cuda.synchronize()
    else:
        with torch.profiler.record_function(_MARK):
            pass


def _between_marks(events: List[dict], on_card: bool) -> List[dict]:
    """The complete events that start after the first mark ends and end
    before the second starts. A trace that lost a mark raises: the tracer
    dropped events at its edges, and the counts would come out short."""
    def is_mark(e: dict) -> bool:
        if on_card:
            return (str(e.get("cat", "")).lower() == "kernel"
                    and _SPIN in str(e.get("name", ""))
                    and float(e.get("dur", 0)) < _MARK_MAX_US)
        return e.get("name") == _MARK

    complete = [e for e in events if e.get("ph") == "X"]
    marks = sorted((e for e in complete if is_mark(e)), key=lambda e: e["ts"])
    if len(marks) != 2:
        raise LostMark(f"the profiler's trace holds {len(marks)} of its 2 "
                       "marks: it lost events at its edges")
    lo = marks[0]["ts"] + marks[0].get("dur", 0)
    hi = marks[1]["ts"]
    return [e for e in complete
            if e["ts"] >= lo and e["ts"] + e.get("dur", 0) <= hi]


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

    Runs once OUTSIDE the traced window (builds, allocator warm-up), so the
    table reflects steady state, and once more before and once after the
    ``iters`` runs inside the trace, where marks fence them off: the
    tracer drops events at the start of its window now and then (on an
    H100: the first launches of a ViT-B forward, the first 3.5 layers of a
    host-bound ViT-Ti stack), and the runs outside the marks take that
    loss; on the card a spin of about 5 ms opens and closes the window
    too, so that a call of microseconds leaves the tracer as much to drop.
    A trace that still lost a mark is thrown away and taken again,
    up to TRACE_ATTEMPTS traces; the last one's loss raises.
    ``fn`` runs ``iters + 3`` times with one trace. Totals cover the
    ``iters`` runs; divide by ``iters`` for per-invocation numbers (the
    call count is as traced). The card is traced when any tensor in
    ``args`` lies on it."""
    on_card = any(t.is_cuda for t in tensors_in(args))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    d = trace_dir or tempfile.mkdtemp(prefix="vit-torch-trace-")
    os.makedirs(d, exist_ok=True)
    activity = torch.profiler.ProfilerActivity
    path = os.path.join(d, "trace.json")
    for attempt in range(TRACE_ATTEMPTS):
        with torch.profiler.profile(
                activities=[activity.CUDA if on_card else activity.CPU]) as prof:
            if on_card:
                torch.cuda._sleep(_GUARD_CYCLES)
            fn(*args)
            _mark(on_card)
            for _ in range(iters):
                fn(*args)
            _mark(on_card)
            fn(*args)
            if on_card:
                torch.cuda._sleep(_GUARD_CYCLES)
            sync()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        try:
            window = _between_marks(events, on_card)
            break
        except LostMark:
            if attempt + 1 == TRACE_ATTEMPTS:
                raise

    agg: dict = {}
    for e in _select_events(window, on_card):
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

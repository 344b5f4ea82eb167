"""Performance tools: the per-op table, traces, throughput and MFU, and
substitution attribution of the forward (``profiler``), and the card's
per-kernel time from a trace (``kernel_trace``). Counterpart of
``vit_with_opencl_tpu/perf`` without ``autotune``, which is not ported
yet."""

from .kernel_trace import (  # noqa: F401
    KernelSpan,
    device_kernel_table,
    format_kernel_table,
)
from .profiler import (  # noqa: F401
    OpProfile,
    attribute_forward,
    format_profile,
    kernel_substitutions,
    profile_ops,
    throughput_report,
    trace,
)

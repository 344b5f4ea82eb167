"""Performance tools: the per-op table, traces, throughput and MFU
(``profiler``), and the card's per-kernel time from a trace
(``kernel_trace``). Counterpart of ``vit_with_opencl_tpu/perf`` without
``autotune`` and ``attribute_forward``/``kernel_substitutions``, which are
not ported yet."""

from .kernel_trace import (  # noqa: F401
    KernelSpan,
    device_kernel_table,
    format_kernel_table,
)
from .profiler import (  # noqa: F401
    OpProfile,
    format_profile,
    profile_ops,
    throughput_report,
    trace,
)

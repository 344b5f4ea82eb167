"""Performance tools: the per-op table, traces, throughput and MFU, and
substitution attribution of the forward (``profiler``), the card's
per-kernel time from a trace (``kernel_trace``), and the tuning cache of
the blockwise forward's key tile (``autotune``: ``python -m
vit_with_opencl_tpu_torch.perf.autotune --config vit_l_16_384 --img-size
512 --batch 16`` on the card). Counterpart of ``vit_with_opencl_tpu/perf``."""

from . import autotune  # noqa: F401

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

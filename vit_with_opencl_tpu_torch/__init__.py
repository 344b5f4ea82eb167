"""vit_with_opencl_tpu_torch — the ViT inference framework on PyTorch and CUDA.

The port of ``vit_with_opencl_tpu`` to an NVIDIA Hopper card (sm_90a). The
module names mirror the JAX package's, so each module's counterpart is found
under the same path there. Plain tensor code is PyTorch; each Pallas kernel
of the JAX package becomes a CUDA kernel written by hand under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).

The port imports nothing of the JAX package: the framework-neutral modules
(``config``, ``io/binfmt``, ``io/labels``, ``harness``, ``models/golden``)
are copies. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper computes its plain
PyTorch version.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CLIP_VIT_B_16,
    DEIT_B_16_224,
    PRESETS,
    VIT_B_16_224,
    VIT_L_16_384,
    VIT_TINY_16_224,
    ViTConfig,
    get_config,
)

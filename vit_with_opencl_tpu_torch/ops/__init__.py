"""Kernel layer: each module holds one hand-written CUDA kernel's wrapper
(launch on a CUDA tensor) beside its plain PyTorch version (computed on a
CPU tensor), and counts its launches.

| JAX package (Pallas, TPU)            | port (CUDA, sm_90a)                  |
|--------------------------------------|--------------------------------------|
| ops/layernorm.py:_ln_kernel          | ops/layernorm.py, csrc/layernorm.cu  |
| ops/linear.py:_linear_kernel         | ops/linear.py, csrc/linear.cu        |
| ops/attention.py:_packed_kernel      | ops/attention.py, csrc/attention.cu  |
| ops/fused_block.py:_block_kernel     | ops/fused_block.py (a chain of the   |
|   (bf16)                             |   three kernels above)               |
| ops/fused_block.py:_block_kernel     | ops/quantize.py, csrc/quantize.cu;   |
|   (quantized: int8 weights, W8A8)    |   the int8 GEMMs of csrc/linear.cu;  |
|                                      |   chained in ops/fused_block.py      |
"""

from .attention import packed_fused_attention  # noqa: F401
from .fused_block import fused_encoder_layer  # noqa: F401
from .layernorm import layer_norm  # noqa: F401
from .linear import fused_linear, fused_linear_w8a8  # noqa: F401
from .quantize import quantize_rows  # noqa: F401

"""Kernel layer: each module holds one hand-written CUDA kernel's wrapper
(launch on a CUDA tensor) beside its plain PyTorch version (computed on a
CPU tensor), and counts its launches.

| JAX package (Pallas, TPU)            | port (CUDA, sm_90a)                  |
|--------------------------------------|--------------------------------------|
| ops/layernorm.py:_ln_kernel          | ops/layernorm.py, csrc/layernorm.cu  |
| ops/linear.py:_linear_kernel         | ops/linear.py, csrc/linear.cu        |
| ops/attention.py:_packed_kernel      | ops/attention.py, csrc/attention.cu  |
| ops/attention.py:_single_pass_kernel | ops/attention.py (flash_attention,   |
|                                      |   single_pass_attention),            |
|                                      |   csrc/attention_single.cu           |
| ops/layernorm.py:_ln_residual_kernel | ops/layernorm.py                     |
|                                      |   (residual_layer_norm),             |
|                                      |   csrc/layernorm.cu                  |
| ops/fused_block.py:_block_kernel     | ops/fused_block.py (a chain of the   |
|   (bf16)                             |   three kernels above)               |
| ops/fused_block.py:_block_kernel     | ops/quantize.py, csrc/quantize.cu;   |
|   (quantized: int8 weights, W8A8)    |   the int8 GEMMs of csrc/linear.cu;  |
|                                      |   chained in ops/fused_block.py      |
| ops/attention.py:_packed_bwd_kernel  | ops/attention.py,                    |
|                                      |   csrc/attention_bwd.cu              |
| ops/attention.py:_flash_kernel,      | ops/attention.py,                    |
|   _flash_kernel_lse,                 |   csrc/attention_flash.cu (with the  |
|   _flash_bwd_dq_kernel,              |   tile helpers of                    |
|   _flash_bwd_dkv_kernel              |   csrc/attention_tiles.cuh)          |
| ops/attention.py:_flash_carry_kernel | ops/attention.py                     |
|   (blockwise_ring_step)              |   (blockwise_ring_step, the local    |
|                                      |   step of ops/ring_attention.py),    |
|                                      |   csrc/attention_ring.cu             |
| ops/fused_block.py:                  | ops/fused_block.py (chains of the    |
|   _attn_half_fwd_kernel,             |   kernels above and of the backward's|
|   _mlp_bwd_kernel, _attn_bwd_kernel  |   GEMM forms in csrc/linear.cu, LN   |
|                                      |   backward in csrc/layernorm.cu and  |
|                                      |   column sum in csrc/reduce.cu)      |

The public ops are JAX's (``flash_attention``, ``layer_norm``,
``residual_layer_norm``, ``fused_linear``, ``softmax``; the last has no
kernel there either: XLA's softmax in fp32, PyTorch's here). JAX's
``flash_attention_interpret`` has no counterpart: it runs the Pallas kernel
in interpret mode off the TPU, and here a CPU tensor takes the plain version.
"""

from .attention import flash_attention, packed_fused_attention  # noqa: F401
from .fused_block import fused_encoder_layer  # noqa: F401
from .layernorm import layer_norm, residual_layer_norm  # noqa: F401
from .linear import fused_linear, fused_linear_w8a8  # noqa: F401
from .quantize import quantize_rows  # noqa: F401
from .softmax import softmax  # noqa: F401

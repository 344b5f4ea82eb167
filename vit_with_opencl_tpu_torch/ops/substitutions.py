"""The attribution probe's kernel substitutions: three process-wide flags.

``perf/profiler.kernel_substitutions`` sets them; the kernel wrappers and
their plain versions read them at every call, so a substituted forward
computes the same stand-in function on the card and on CPU tensors (the
JAX package swaps module attributes while its programs trace; the port
launches eagerly, so the state is read at launch time):

  * ``GELU_IDENTITY``: ``fused_block._gelu_fast`` is the identity wherever
    the forward applies it (the GEMM epilogues of fc1, launched with the
    run-time ``gelu`` flag at 0, and the plain ``_epilogue``);
  * ``SOFTMAX_IDENTITY``: the attention core is JAX's ``fake_head``: ``o =
    bf16(s · float32(1/T)) · v`` with ``s = (q · scale) · kᵀ`` in fp32 (no
    max, no exp, no row sum, both products kept); the packed kernel's slab
    entry runs its constant-scale form, the attention routes that have no
    stand-in on the card raise ``NotImplementedError``;
  * ``QUANT_CHEAP``: ``models/quant.quantize_act`` is a bare convert (the
    codes the fp32 values truncated toward zero, saturated to int8; a scale
    of 1.0 a row); the row quantizes run their cheap forms.

Nothing here imports the rest of the package, so that ``models/quant`` and
the kernel modules can read the flags without an import cycle.
"""

from __future__ import annotations

import torch

GELU_IDENTITY = False
SOFTMAX_IDENTITY = False
QUANT_CHEAP = False


def state() -> tuple:
    """(GELU_IDENTITY, SOFTMAX_IDENTITY, QUANT_CHEAP)."""
    return GELU_IDENTITY, SOFTMAX_IDENTITY, QUANT_CHEAP


def set_state(gelu_identity: bool, softmax_identity: bool,
              quant_cheap: bool) -> None:
    global GELU_IDENTITY, SOFTMAX_IDENTITY, QUANT_CHEAP
    GELU_IDENTITY = bool(gelu_identity)
    SOFTMAX_IDENTITY = bool(softmax_identity)
    QUANT_CHEAP = bool(quant_cheap)


def refuse(what: str, substitution: str) -> None:
    """Raise for a card launch that has no stand-in of ``substitution``:
    the real kernel must not run where the substitution changes the math."""
    raise NotImplementedError(
        f"{what} has no compiled stand-in for the {substitution} substitution "
        "on the card; attribute a route that has one (the packed attention's "
        "slab entry, the row quantizes at their compiled widths, the forward "
        "GEMMs), or run on CPU tensors")


def check_launch(what: str) -> None:
    """Called by a card wrapper before it launches a stand-in: a CUDA graph
    captured now would keep the stand-in's math after the substitution
    ends, so capture is refused while one is on."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: a kernel substitution is active; a CUDA graph captured "
            "now would replay the stand-in after it ends")

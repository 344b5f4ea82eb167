"""Fused linear layer: the forms of the Hopper GEMM core ``csrc/gemm_sm90.cuh``
(bf16 x with a bf16 or int8 w, and W8A8), and their plain versions.

Replaces ``vit_with_opencl_tpu/ops/linear.py:_linear_kernel``
(``fused_linear``) and is the GEMM link of the encoder chains
(``ops/fused_block.py``). The product accumulates in fp32 (int32 for W8A8);
the epilogue adds, in fp32 and in this order, an optional residual, the bias,
the optional ``_gelu_fast``, and casts to ``out_dtype``. The residual and
``out_dtype`` are the port's additions for the chain: the layer keeps its
residual stream in fp32 between kernels. Four forms of one kernel, each
with its own launch count:

  * ``fused_linear`` with bf16 ``w``: bf16 x @ bf16 w on the Hopper core
    (TMA and wgmma, ``LAUNCHES``);
  * ``fused_linear`` with int8 ``w`` and ``w_scale``: weight-only int8 on
    the same Hopper core, w loaded by TMA as int8 and widened to bf16 in
    shared memory by the consuming warpgroup, the fp32 product times the
    per-column scale (``LAUNCHES_INT8W``);
  * ``fused_linear_w8a8``: int8 x (with its per-row scale, from
    ``ops/quantize.py``) @ int8 w on the same core's int8 ``wgmma``
    (int32 sums), ``acc · s_x · s_w`` (``LAUNCHES_W8A8``); with ``x_hi``
    and ``w_hi`` (the outlier-aware layer's bf16 groups) the same kernel
    also runs the bf16 side product and adds it after the scales
    (``LAUNCHES_W8A8_HI``). On the card w must be stored K-major
    (``models/quant.k_major``: int8 ``wgmma`` reads no other layout); the
    wrapper raises on any other, and never transposes a weight itself.

Bound on the card: operations (see the notes in the sources). The kernels
take bf16 or int8 operands; fp32 ``x`` on the card is not supported yet.

The training backward's GEMM forms run on the same Hopper core, the operand
layouts its transpose bits (each form with its own launch count):

  * ``linear_dgrad``: ``dY @ Wᵀ`` with W stored [K, N], optionally times
    ``_gelu_fast_grad(pre)``, with an optional second output rounded to
    bf16 (``LAUNCHES_DGRAD``);
  * ``linear_wgrad``: ``Xᵀ @ dY`` over the tokens into an fp32 weight
    gradient (``LAUNCHES_WGRAD``, one a call): the token axis split into
    ``_wgrad_splits`` runs whose fp32 partials a second kernel sums in a
    fixed order (``linear_wgrad_split_reference`` is its plain twin), so
    one call launches two kernels when it splits and the result has the
    same bits from run to run;
  * ``fused_linear_with_gelu``: the fc1 recompute, ``x @ w + b`` in fp32
    beside its ``_gelu_fast`` rounded to bf16 (``LAUNCHES_GELU_PAIR``).

The forward wrappers refuse to run under autograd on the card (their
results would carry no graph): training goes through
``ops/fused_block.fused_encoder_layer_trainable``.

Each wrapper launches its kernel for a CUDA tensor and computes its
``*_reference`` for a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the bf16 GEMM, the int8-weight GEMM, the W8A8 GEMM and the W8A8 GEMM
# with the bf16 side product.
LAUNCHES = 0
LAUNCHES_INT8W = 0
LAUNCHES_W8A8 = 0
LAUNCHES_W8A8_HI = 0
# The backward's forms: dgrad, wgrad and the fc1 recompute.
LAUNCHES_DGRAD = 0
LAUNCHES_WGRAD = 0
LAUNCHES_GELU_PAIR = 0
_TRAINABLE = "ops/fused_block.fused_encoder_layer_trainable"

_RESIDUAL_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def _epilogue(out: torch.Tensor, b, residual, fuse_gelu: bool,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The plain epilogue on an fp32 [M, N] product."""
    from .fused_block import _gelu_fast

    if residual is not None:
        out = residual.reshape(out.shape).float() + out
    if b is not None:
        out = out + b.float()
    if fuse_gelu:
        out = _gelu_fast(out)
    return out.to(out_dtype)


def fused_linear_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    w_scale: Optional[torch.Tensor] = None,
    fuse_gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``epilogue(x @ w [* w_scale])`` with an fp32-output GEMM (never a
    bf16-output matmul, which would round where the reference does not)."""
    *lead, k = x.shape
    n = w.shape[1]
    out = x.reshape(-1, k).float() @ w.float()
    if w_scale is not None:
        out = out * w_scale.reshape(n).float()
    out = _epilogue(out, b, residual, fuse_gelu, out_dtype or x.dtype)
    return out.reshape(*lead, n)


def _check_epilogue(lead, n, dev, b, residual, out_dtype) -> None:
    if b is not None:
        _build.require(b, "b", device=dev, dtypes=(torch.float32,), shape=(n,))
    if residual is not None:
        _build.require(residual, "residual", device=dev,
                       dtypes=(torch.float32, torch.bfloat16),
                       shape=(*lead, n))
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _scale_vector(s: torch.Tensor, n: int, name: str, dev) -> torch.Tensor:
    """A per-column scale [N] or [1, N] as a contiguous fp32 [N] view."""
    if s.numel() != n:
        raise ValueError(f"{name} has shape {tuple(s.shape)}, expected ({n},)")
    s = s.reshape(n)
    _build.require(s, name, device=dev, dtypes=(torch.float32,))
    return s


def fused_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    w_scale: Optional[torch.Tensor] = None,
    fuse_gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, N] (right-multiply layout) with bias ``b``
    [N] (fp32), an optional ``residual`` [..., N] (fp32 or bf16) added before
    the bias, and an optional ``_gelu_fast``. Result in ``out_dtype``
    (default x's dtype). An int8 ``w`` needs its per-column fp32 ``w_scale``
    ([N] or [1, N]), which multiplies the product before the epilogue."""
    global LAUNCHES, LAUNCHES_INT8W
    out_dtype = out_dtype or x.dtype
    int8w = w.dtype == torch.int8
    if int8w != (w_scale is not None):
        raise ValueError("w_scale goes with an int8 w, and only with one")
    if not x.is_cuda:
        return fused_linear_reference(x, w, b, w_scale=w_scale,
                                      fuse_gelu=fuse_gelu, residual=residual,
                                      out_dtype=out_dtype)
    *lead, k = x.shape
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.bfloat16, torch.int8):
        raise NotImplementedError(
            "the CUDA GEMM takes bf16 x and a bf16 or int8 w; an fp32 variant "
            f"is not ported yet (got x {x.dtype}, w {w.dtype})")
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({k}, N)")
    n = w.shape[1]
    if k % 8 or n % (16 if int8w else 8):
        raise ValueError(f"K={k} must be a multiple of 8 and N={n} of "
                         f"{16 if int8w else 8}")
    _build.refuse_autograd("fused_linear", (x, w, b, w_scale, residual),
                           _TRAINABLE)
    _build.require(x, "x", device=x.device, dtypes=(torch.bfloat16,))
    _build.require(w, "w", device=x.device, dtypes=(w.dtype,))
    _check_epilogue(lead, n, x.device, b, residual, out_dtype)
    out = torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    m = x.numel() // k
    if m == 0:
        return out
    tail = (_ptr(b), _ptr(residual),
            _RESIDUAL_KINDS[None if residual is None else residual.dtype],
            out.data_ptr(), int(out_dtype == torch.bfloat16), int(fuse_gelu),
            m, n, k)
    if int8w:
        s = _scale_vector(w_scale, n, "w_scale", x.device)
        err = _build.launch("vit_linear_int8w", x, x.data_ptr(), w.data_ptr(),
                            s.data_ptr(), *tail)
        _build.check_launch(err, "fused_linear (int8 w)")
        LAUNCHES_INT8W += 1
    else:
        err = _build.launch("vit_linear_bf16", x, x.data_ptr(), w.data_ptr(),
                            *tail)
        _build.check_launch(err, "fused_linear")
        LAUNCHES += 1
    return out


def _require_k_major(wq: torch.Tensor, k: int, dev) -> None:
    """What the W8A8 kernel reads: an int8 [K, N] stored K-major (each
    column's K values contiguous, columns 16-byte-aligned rows apart)."""
    if wq.device != dev:
        raise ValueError(f"wq is on {wq.device}, expected {dev}")
    if wq.dtype != torch.int8:
        raise TypeError(f"wq has dtype {wq.dtype}, expected torch.int8")
    ld = wq.stride(1)
    if wq.stride(0) != 1 or ld < k or ld % 16 or wq.data_ptr() % 16:
        raise ValueError(
            f"wq [K={k}, N] must be stored K-major (strides (1, ld), ld >= K a "
            f"multiple of 16, 16-byte aligned), got strides {wq.stride()}: "
            "int8 wgmma reads no other layout; store the weights so once "
            "(models/quant.k_major or w8a8_layout)")


def fused_linear_w8a8_reference(
    xq: torch.Tensor,
    sx: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    fuse_gelu: bool = False,
    out_dtype: torch.dtype = torch.float32,
    x_hi: Optional[torch.Tensor] = None,
    w_hi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``epilogue((xq @ wq) · sx · sw [+ x_hi @ w_hi])``: the integer sums
    exactly (in float64), rounded once to fp32, then the scales in the TPU
    kernel's order, ``(acc · s_x) · s_w``, then the side product (fp32
    accumulation of the operands as given)."""
    from ..models.quant import int8_product

    *lead, k = xq.shape
    n = wq.shape[1]
    acc = int8_product(xq.reshape(-1, k), wq)
    out = acc * sx.reshape(-1, 1).float() * sw.reshape(1, n).float()
    if x_hi is not None:
        out = out + x_hi.reshape(-1, x_hi.shape[-1]).float() @ w_hi.float()
    return _epilogue(out, b, residual, fuse_gelu, out_dtype).reshape(*lead, n)


def fused_linear_w8a8(
    xq: torch.Tensor,
    sx: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    fuse_gelu: bool = False,
    out_dtype: torch.dtype = torch.float32,
    x_hi: Optional[torch.Tensor] = None,
    w_hi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W8A8 GEMM: ``xq`` [..., K] int8 with its per-row scale ``sx``
    [..., 1] (``ops/quantize.quantize_rows``) @ ``wq`` [K, N] int8 with its
    per-column scale ``sw`` ([N] or [1, N]), int32 accumulation, then
    ``(acc · s_x) · s_w``, plus the side product ``x_hi`` [..., K_hi] @
    ``w_hi`` [K_hi, N] (bf16 on the card, fp32 accumulation) if given, then
    the residual, the bias and the GELU in fp32. K and N must be multiples
    of 16, K_hi of 8. On the card ``wq`` must be stored K-major
    (``models/quant.k_major``, as ``quant.w8a8_layout`` stores the W8A8
    params): strides (1, ld) with ld >= K a multiple of 16, 16-byte
    aligned."""
    global LAUNCHES_W8A8, LAUNCHES_W8A8_HI
    if (x_hi is None) != (w_hi is None):
        raise ValueError("x_hi and w_hi go together")
    if not xq.is_cuda:
        return fused_linear_w8a8_reference(xq, sx, wq, sw, b, residual=residual,
                                           fuse_gelu=fuse_gelu,
                                           out_dtype=out_dtype, x_hi=x_hi,
                                           w_hi=w_hi)
    *lead, k = xq.shape
    if wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"wq has shape {tuple(wq.shape)}, expected ({k}, N)")
    n = wq.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"K={k} and N={n} must be multiples of 16")
    m = xq.numel() // k if k else 0
    _build.refuse_autograd("fused_linear_w8a8",
                           (xq, sx, wq, sw, b, residual, x_hi, w_hi), _TRAINABLE)
    _build.require(xq, "xq", device=xq.device, dtypes=(torch.int8,))
    _require_k_major(wq, k, xq.device)
    if sx.numel() != m:
        raise ValueError(f"sx has shape {tuple(sx.shape)}, expected "
                         f"({', '.join(map(str, lead))}, 1)")
    _build.require(sx, "sx", device=xq.device, dtypes=(torch.float32,))
    s = _scale_vector(sw, n, "sw", xq.device)
    _check_epilogue(lead, n, xq.device, b, residual, out_dtype)
    k_hi = 0
    if x_hi is not None:
        k_hi = x_hi.shape[-1]
        if k_hi % 8:
            raise ValueError(f"K_hi={k_hi} must be a multiple of 8")
        _build.require(x_hi, "x_hi", device=xq.device, dtypes=(torch.bfloat16,),
                       shape=(*lead, k_hi))
        _build.require(w_hi, "w_hi", device=xq.device, dtypes=(torch.bfloat16,),
                       shape=(k_hi, n))
    out = torch.empty((*lead, n), dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    err = _build.launch("vit_linear_w8a8", xq,
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), wq.stride(1), s.data_ptr(),
        _ptr(x_hi), _ptr(w_hi), k_hi, _ptr(b), _ptr(residual),
        _RESIDUAL_KINDS[None if residual is None else residual.dtype],
        out.data_ptr(), int(out_dtype == torch.bfloat16), int(fuse_gelu),
        m, n, k)
    if x_hi is None:
        _build.check_launch(err, "fused_linear_w8a8")
        LAUNCHES_W8A8 += 1
    else:
        _build.check_launch(err, "fused_linear_w8a8 (bf16 side product)")
        LAUNCHES_W8A8_HI += 1
    return out


# ---------------------------------------------------------------------------
# The backward's GEMM forms
# ---------------------------------------------------------------------------


def _grad_gemm(what: str, a, a_trans: bool, b, b_trans: bool, m: int, n: int,
               k: int, out_shape, *, bias=None, gelu_grad_of=None,
               out_dtype=torch.float32, out2: bool = False,
               out2_gelu: bool = False, split: bool = False):
    """Launch the Hopper core's backward forms (operands checked by the
    caller); ``split``: the wgrad form's split-K over ``k`` (the tokens)."""
    dev = a.device
    # TMA copies 16-byte rows along each operand's contiguous axis.
    if n % 8 or (m if a_trans else k) % 8 or (b_trans and k % 8):
        raise ValueError(f"{what}: N={n} and the operands' contiguous axes "
                         f"(M={m} if A is transposed, else K={k}) must be "
                         "multiples of 8")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    _build.require(a, "a", device=dev, dtypes=(torch.bfloat16,))
    _build.require(b, "b", device=dev, dtypes=(torch.bfloat16,))
    if bias is not None:
        _build.require(bias, "bias", device=dev, dtypes=(torch.float32,),
                       shape=(n,))
    if gelu_grad_of is not None:
        _build.require(gelu_grad_of, "gelu_grad_of", device=dev,
                       dtypes=(torch.float32,), shape=out_shape)
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    second = (torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
              if out2 else None)
    if m and n and k:
        full, splits, split_k, parts = 0, 1, 0, None
        if split:
            full, splits, split_k = _wgrad_splits(k, m, n, _sm_count(dev.index))
            if splits > 1:
                rest = _tiles(m, n) - full
                parts = torch.empty((splits, rest, _TILE_MN, _TILE_MN),
                                    dtype=torch.float32, device=dev)
        err = _build.launch("vit_gemm_grad", a,
            a.data_ptr(), int(a_trans), b.data_ptr(), int(b_trans),
            _ptr(bias), _ptr(gelu_grad_of), out.data_ptr(),
            int(out_dtype == torch.bfloat16), _ptr(second), int(out2_gelu),
            m, n, k, full, splits, split_k, _ptr(parts))
        _build.check_launch(err, what)
    elif not k:
        out.zero_()
    return out, second


def linear_dgrad_reference(dy: torch.Tensor, w: torch.Tensor, *,
                           gelu_grad_of: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.float32,
                           out2_dtype: Optional[torch.dtype] = None):
    """``dy`` [..., N] @ ``w``ᵀ (``w`` stored [K, N]) with an fp32 product,
    times ``_gelu_fast_grad(gelu_grad_of)`` if given; in ``out_dtype``, and
    with ``out2_dtype`` also the same values in that dtype (a pair)."""
    from .fused_block import _gelu_fast_grad

    *lead, n = dy.shape
    k = w.shape[0]
    out = dy.reshape(-1, n).float() @ w.float().t()
    if gelu_grad_of is not None:
        out = out * _gelu_fast_grad(gelu_grad_of.reshape(-1, k).float())
    out = out.reshape(*lead, k)
    if out2_dtype is None:
        return out.to(out_dtype)
    return out.to(out_dtype), out.to(out2_dtype)


def linear_dgrad(dy: torch.Tensor, w: torch.Tensor, *,
                 gelu_grad_of: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.float32,
                 out2_dtype: Optional[torch.dtype] = None):
    """The input gradient of ``x @ w``: ``dy`` [..., N] (bf16 on the card)
    @ ``w``ᵀ, ``w`` [K, N] as the forward stores it; times
    ``_gelu_fast_grad`` of the fp32 pre-activation ``gelu_grad_of``
    [..., K] if given (the gradient through fc1's GELU). ``out2_dtype``
    (bf16 on the card) adds a second output: the same values rounded."""
    global LAUNCHES_DGRAD
    if not dy.is_cuda:
        return linear_dgrad_reference(dy, w, gelu_grad_of=gelu_grad_of,
                                      out_dtype=out_dtype, out2_dtype=out2_dtype)
    *lead, n = dy.shape
    if w.dim() != 2 or w.shape[1] != n:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected (K, {n})")
    if out2_dtype not in (None, torch.bfloat16):
        raise TypeError(f"out2_dtype {out2_dtype}: the kernel's second output "
                        "is bf16")
    k = w.shape[0]
    out, second = _grad_gemm("linear_dgrad", dy, False, w, True, dy.numel() // n
                             if n else 0, k, n, (*lead, k),
                             gelu_grad_of=gelu_grad_of, out_dtype=out_dtype,
                             out2=out2_dtype is not None)
    LAUNCHES_DGRAD += 1
    return out if second is None else (out, second)


def linear_wgrad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K]ᵀ @ ``dy`` [..., N] over every token: fp32 [K, N]."""
    k, n = x.shape[-1], dy.shape[-1]
    return x.reshape(-1, k).float().t() @ dy.reshape(-1, n).float()


# The Hopper core's tile (csrc/gemm_sm90.cuh): 128 x 128 outputs, 64-deep K
# slices; a split weight gradient's runs hold at least _MIN_SPLIT_SLICES
# slices.
_TILE_MN, _TILE_K = 128, 64
_MIN_SPLIT_SLICES = 4
# Its ring of bf16 A and B slices, and the int8-weight form's ring of int8
# w slices beside it.
GEMM_STAGES = 4
INT8W_STAGES = 3
_EPI_PITCH = _TILE_MN + 8  # the epilogue's fp32 staging rows, padded
_CONSUMERS = 2


# The W8A8 forms' slices: 128 rows of 128 int8 values (128 bytes) of xq and
# of the K-major w.
_TILE_K8 = 128


def w8a8_kernel_smem_bytes(side: bool = False) -> int:
    """Shared memory of one block of the core's W8A8 forms (``kSmemBytes``
    too): the ring of stages holding a 128 x 128-byte int8 xq slice and one
    of the K-major w, with ``side`` also a 128 x 64 bf16 x_hi slice and a
    64 x 128 bf16 w_hi one (into the same stages), the staging tiles and
    the barriers."""
    stage = 2 * _TILE_MN * _TILE_K8
    if side:
        stage = max(stage, 2 * _TILE_MN * _TILE_K * 2)
    ring = GEMM_STAGES * stage
    staging = _CONSUMERS * 64 * _EPI_PITCH * 4
    return 1024 + ring + staging + (2 * GEMM_STAGES + 2) * 8


def gemm_kernel_smem_bytes() -> int:
    """Shared memory of one block of the Hopper GEMM core's bf16 forms
    (csrc/gemm_sm90.cuh ``kSmemBytes``): 1024 bytes of alignment slack, the
    ring of 128 x 64 bf16 A and B slices, the two consumer warpgroups'
    64-row fp32 staging tiles and the barriers (full and empty a stage, two
    turns)."""
    ring = GEMM_STAGES * 2 * _TILE_MN * _TILE_K * 2
    staging = _CONSUMERS * 64 * _EPI_PITCH * 4
    return 1024 + ring + staging + (2 * GEMM_STAGES + 2) * 8


def int8w_kernel_smem_bytes(int8_stages: int = INT8W_STAGES) -> int:
    """Shared memory of one block of the core's int8-weight form
    (``kSmemBytesI8``): the bf16 form's, and a ring of ``int8_stages``
    [64 K, 128 N] int8 w slices (8 KiB each) with a full and an empty
    barrier a slot."""
    return gemm_kernel_smem_bytes() + int8_stages * (_TILE_K * _TILE_MN + 2 * 8)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _tiles(k: int, n: int) -> int:
    """The 128 x 128 tiles of a [K, N] output, in row-major order."""
    return -(-k // _TILE_MN) * -(-n // _TILE_MN)


@functools.lru_cache(maxsize=None)  # host time on every wgrad launch otherwise
def _wgrad_splits(m_tokens: int, k: int, n: int,
                  sms: int = 132) -> tuple[int, int, int]:
    """The split-K of a weight gradient ``[K, N] = Xᵀ · dY`` over
    ``m_tokens`` tokens: ``(full, S, split_k)``. Tiles ``0..full-1`` (in
    row-major order) run whole; the others run over the token axis in S
    runs of ``split_k`` tokens (a multiple of the 64-deep K slice; the last
    run ragged, none empty: ``(S - 1) · split_k < m_tokens <= S · split_k``).
    S = 1 means no split: ``full`` is every tile and ``split_k`` covers the
    tokens.

    A [K, N] gradient has few 128 x 128 tiles against the SMs (36 at ViT-B's
    out-proj for 132, 144 at fc1), and each walks every token. ``full`` is
    the tiles of the whole waves (a multiple of ``sms``); the rest split
    into the most runs that fit in one round of the SMs, with runs of at
    least ``_MIN_SPLIT_SLICES`` slices. The bound: S = 1, or ``(tiles -
    full) · S <= sms``."""
    if m_tokens < 1 or k < 1 or n < 1 or sms < 1:
        raise ValueError(f"_wgrad_splits({m_tokens}, {k}, {n}, sms={sms})")
    tiles = _tiles(k, n)
    slices = -(-m_tokens // _TILE_K)
    full = tiles // sms * sms
    rest = tiles - full
    s = min(sms // rest, slices // _MIN_SPLIT_SLICES) if rest else 1
    if s <= 1:
        return tiles, 1, slices * _TILE_K
    chunk = -(-slices // s)
    return full, -(-slices // chunk), chunk * _TILE_K


def linear_wgrad_split_reference(x: torch.Tensor, dy: torch.Tensor, full: int,
                                 splits: int, split_k: int) -> torch.Tensor:
    """The split-K wgrad's plain twin: the whole product for tiles
    ``0..full-1``; for the others, fp32 partials over the token runs of
    ``_wgrad_splits`` summed in index order s = 0..S-1, as the card's second
    kernel sums them."""
    k, n = x.shape[-1], dy.shape[-1]
    x2, dy2 = x.reshape(-1, k).float(), dy.reshape(-1, n).float()
    out = x2.t() @ dy2
    if splits == 1:
        return out
    summed = None
    for s in range(splits):
        rows = slice(s * split_k, (s + 1) * split_k)
        part = x2[rows].t() @ dy2[rows]
        summed = part if summed is None else summed + part
    tiles_n = -(-n // _TILE_MN)
    for tile in range(full, _tiles(k, n)):
        r = slice(tile // tiles_n * _TILE_MN, (tile // tiles_n + 1) * _TILE_MN)
        c = slice(tile % tiles_n * _TILE_MN, (tile % tiles_n + 1) * _TILE_MN)
        out[r, c] = summed[r, c]
    return out


def linear_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``x @ w``: ``x`` [..., K]ᵀ @ ``dy`` [..., N]
    (bf16 on the card), summed over all B·T tokens in fp32 → [K, N]."""
    global LAUNCHES_WGRAD
    if not x.is_cuda:
        return linear_wgrad_reference(x, dy)
    k, n = x.shape[-1], dy.shape[-1]
    m = x.numel() // k if k else 0
    if dy.numel() != m * n:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} hold "
                         "different token counts")
    # Xᵀ [K, M] is A read transposed: the GEMM's M is K, its K the tokens.
    out, _ = _grad_gemm("linear_wgrad", x, True, dy, False, k, n, m, (k, n),
                        split=True)
    LAUNCHES_WGRAD += 1
    return out


def fused_linear_with_gelu_reference(x: torch.Tensor, w: torch.Tensor,
                                     b: torch.Tensor, *,
                                     out2_dtype: Optional[torch.dtype] = None):
    """(``x @ w + b`` in fp32, ``_gelu_fast`` of it in ``out2_dtype``,
    default x's)."""
    from .fused_block import _gelu_fast

    *lead, k = x.shape
    pre = (x.reshape(-1, k).float() @ w.float() + b.float()).reshape(
        *lead, w.shape[1])
    return pre, _gelu_fast(pre).to(out2_dtype or x.dtype)


def fused_linear_with_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           *, out2_dtype: Optional[torch.dtype] = None):
    """The MLP backward's fc1 recompute: ``x`` [..., K] @ ``w`` [K, N] +
    ``b`` as fp32 ``hid_pre`` (for the GELU gradient) and its
    ``_gelu_fast`` rounded to bf16 (for dfc2_w), from one GEMM."""
    global LAUNCHES_GELU_PAIR
    if not x.is_cuda:
        return fused_linear_with_gelu_reference(x, w, b, out2_dtype=out2_dtype)
    *lead, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({k}, N)")
    if (out2_dtype or x.dtype) != torch.bfloat16:
        raise TypeError("the kernel's GELU output is bf16")
    n = w.shape[1]
    out, second = _grad_gemm("fused_linear_with_gelu", x, False, w, False,
                             x.numel() // k if k else 0, n, k, (*lead, n),
                             bias=b, out2=True, out2_gelu=True)
    LAUNCHES_GELU_PAIR += 1
    return out, second

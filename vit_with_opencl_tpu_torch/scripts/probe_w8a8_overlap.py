"""Can CUDA-core work overlap the int8 tensor cores inside one kernel?

Counterpart of ``scripts/probe_w8a8_overlap.py``. The W8A8 chain spends
0.66-0.71 ms a ViT-B layer in its quantizes beside 3.81 ms of int8 GEMMs
(``PERF.md`` §5, batch 256): whether that work can hide behind the GEMMs
decides whether fusing the quantizes into them pays. The probe measures the
question directly with synthetic kernels whose dependency graphs isolate the
overlap (``csrc/probe_overlap.cu``):

  stream    read every block whole, write a tiny slice (the read baseline)
  vpu:q     per-row absmax int8 quantization only (the W8A8 stage)
  vpu:ln    fp32 LayerNorm without affine only (the other big row stage)
  mxu       int8 x int8 -> int32 GEMM only, fp32 scale epilogue
  fused     quantize chunk c -> GEMM chunk c (the production W8A8 shape)
  indep     quantize (or LN) of stream A beside the GEMM of stream B, with
            NO data dependency between them: three warpgroups run the GEMM
            (a TMA producer, two wgmma consumers) and a fourth of the same
            block the row work. If the SM issues both side by side, this
            runs at max(vpu, mxu); if they share issue slots or memory
            bandwidth, at vpu + mxu.

Interpretation:
  indep ~= max(vpu, mxu)  -> the row work hides behind the GEMM; fusing the
                             quantizes into the GEMMs (or running them
                             beside) would take them off the layer's time.
  indep ~= vpu + mxu      -> the two serialise on this design; a fused
                             quantize saves only the round trip's bytes.

Shapes mirror the ViT-B fc1 GEMM (K = 768, N = 3072), 1024-row blocks of 8
chunks of 128 rows, a grid of 256 blocks (262,144 rows). Every output's
index map is constant, as in the TPU kernels: the result is the last
block's rows, and every block's work is done. Bounds on an H100 SXM (3.35
TB/s, 1979 int8 TOP/s): stream, vpu:q and vpu:ln read 805.3 MB of fp32,
0.2404 ms (bytes); mxu does 1.237e12 int8 operations, 0.6250 ms; fused and
indep as much, 0.6250 ms (operations; indep's 1006.6 MB of inputs alone
0.3005 ms). Each time is the best of 3 chains of 50 launches, over CUDA
events.

Each kernel has a wrapper that launches it for CUDA tensors (and counts the
launch) and a plain PyTorch version beside it, which the wrapper computes
for CPU tensors; the plain versions walk the grid block by block, each
overwriting the outputs, as the TPU grid does. The GEMM kernels run on
Hopper's int8 ``wgmma``, which reads w K-major only: on the card their
wrappers take w stored so (``models/quant.k_major``, as ``weights()``
returns it) and refuse a row-major one; the plain versions take either.

Run on the card:  python -m vit_with_opencl_tpu_torch.scripts.probe_w8a8_overlap
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..engine import resolve_device
from ..models.quant import k_major
from ..models.quant import quantize_act as _quantize_rows
from ..ops import _build
from ..ops.linear import _require_k_major

M_BLOCK = 1024
N_CHUNKS = 8
M_CHUNK = M_BLOCK // N_CHUNKS
K = 768
N = 3072
GRID = 256
EPS = 1e-6
REPS = 3  # best of
CHAIN = 50  # launches a timed chain

# The H100 SXM's published rates (NVIDIA's data sheet, 700 W): device
# memory bytes/s and dense int8 tensor-core operations/s.
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12

# Kernel launches since the counts were last set to 0, one count a form.
LAUNCHES_STREAM = 0
LAUNCHES_VPU_QUANT = 0
LAUNCHES_VPU_LN = 0
LAUNCHES_MXU = 0
LAUNCHES_FUSED = 0
LAUNCHES_INDEP_QUANT = 0
LAUNCHES_INDEP_LN = 0

# _x_f32's constants, as fp32 values.
_F32_0_013 = float(np.float32(0.013))
_F32_1_6 = float(np.float32(1.6))

# The kernels' scratch: one checksum word a warp of the launched grid. The
# row kernels launch a block of 8 warps a 128-row chunk; the GEMM kernels a
# persistent grid (``_gemm_grid``) of 12 warps a block (16 for indep).
_ROW_KERNEL_WARPS = 8
_GEMM_WARPS = 12
_INDEP_WARPS = 16


def _ln(xf: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [m, k] @ int8 b [k, n] → the exact int32 sums: in float64,
    whose 53 bits hold every partial sum exactly (|sum| < 2^24 here), on
    the CPU and the card alike (torch has no int32 matmul on the card)."""
    return (a.double() @ b.double()).to(torch.int32)


# --- plain versions -----------------------------------------------------


def stream_reference(x: torch.Tensor) -> torch.Tensor:
    out = None
    for blk in x.split(M_BLOCK):
        out = blk[:8, :128] * 2.0
    return out


def vpu_quant_reference(x: torch.Tensor):
    out = None
    for blk in x.split(M_BLOCK):
        out = _quantize_rows(blk)
    return out


def vpu_ln_reference(x: torch.Tensor) -> torch.Tensor:
    out = None
    for blk in x.split(M_BLOCK):
        out = _ln(blk).to(torch.bfloat16)
    return out


def _mxu_block(xq: torch.Tensor, w: torch.Tensor, sw: torch.Tensor):
    return (_int_dot(xq, w).float() * sw).to(torch.bfloat16)


def mxu_reference(xq: torch.Tensor, w: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    out = None
    for blk in xq.split(M_BLOCK):
        out = _mxu_block(blk, w, sw)
    return out


def fused_reference(x: torch.Tensor, w: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    out = None
    for blk in x.split(M_BLOCK):
        q, s = _quantize_rows(blk)
        out = (_int_dot(q, w).float() * s * sw).to(torch.bfloat16)
    return out


def indep_reference(xa: torch.Tensor, xqb: torch.Tensor, w: torch.Tensor,
                    sw: torch.Tensor, vpu_op: str = "quant"):
    _check_vpu_op(vpu_op)
    out = None
    for blk_a, blk_b in zip(xa.split(M_BLOCK), xqb.split(M_BLOCK)):
        if vpu_op == "quant":
            oq, os_ = _quantize_rows(blk_a)
        else:
            oq, os_ = _ln(blk_a).to(torch.bfloat16)[:, :K], blk_a[:, :1]
        out = (oq, os_, _mxu_block(blk_b, w, sw))
    return out


# --- kernels ------------------------------------------------------------


def _check_vpu_op(vpu_op: str) -> None:
    if vpu_op not in ("quant", "ln"):
        raise ValueError(f"vpu_op must be 'quant' or 'ln', got {vpu_op!r}")


def _grid_of(x: torch.Tensor, name: str, dtype: torch.dtype) -> int:
    """Check a [blocks * M_BLOCK, K] operand; the number of grid blocks."""
    _build.require(x, name, device=x.device, dtypes=(dtype,))
    if x.dim() != 2 or x.shape[1] != K or x.shape[0] % M_BLOCK or not x.shape[0]:
        raise ValueError(f"{name} must be [blocks * {M_BLOCK}, {K}], got "
                         f"{tuple(x.shape)}")
    return x.shape[0] // M_BLOCK


def _check_weights(w: torch.Tensor, sw: torch.Tensor, device) -> int:
    """Check w int8 [K, n] stored K-major (what the GEMM kernels' TMA and
    int8 wgmma read) and sw fp32 [1, n]; n (a multiple of 128)."""
    n = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != K or n % 128 or not n:
        raise ValueError(f"w must be [{K}, n] with n a multiple of 128, got "
                         f"{tuple(w.shape)}")
    _require_k_major(w, K, device, "w")
    _build.require(sw, "sw", device=device, dtypes=(torch.float32,),
                   shape=(1, n))
    return n


def _scratch(words: int, device) -> torch.Tensor:
    return torch.empty(words, dtype=torch.int32, device=device)


def _row_scratch(blocks: int, device) -> torch.Tensor:
    return _scratch(blocks * N_CHUNKS * _ROW_KERNEL_WARPS, device)


def _gemm_grid(blocks: int, device) -> int:
    """The GEMM kernels' persistent grid: a block an SM, at most one a
    128-row chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(blocks * N_CHUNKS, sms)


def stream(x: torch.Tensor) -> torch.Tensor:
    """fp32 x [blocks * 1024, 768] → fp32 [8, 128]: the last block's
    ``x[:8, :128] * 2``, after reading every block whole."""
    global LAUNCHES_STREAM
    if not x.is_cuda:
        return stream_reference(x)
    blocks = _grid_of(x, "x", torch.float32)
    o = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    err = _build.launch("vit_probe_stream", x, x.data_ptr(), o.data_ptr(),
                        _row_scratch(blocks, x.device).data_ptr(), blocks)
    _build.check_launch(err, "probe stream")
    LAUNCHES_STREAM += 1
    return o


def vpu_quant(x: torch.Tensor):
    """fp32 x → the last block's (int8 [1024, 768], fp32 scale [1024, 1])."""
    global LAUNCHES_VPU_QUANT
    if not x.is_cuda:
        return vpu_quant_reference(x)
    blocks = _grid_of(x, "x", torch.float32)
    q = torch.empty((M_BLOCK, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M_BLOCK, 1), dtype=torch.float32, device=x.device)
    err = _build.launch("vit_probe_vpu", x, x.data_ptr(), 0, q.data_ptr(),
                        s.data_ptr(), _row_scratch(blocks, x.device).data_ptr(),
                        blocks)
    _build.check_launch(err, "probe vpu:q")
    LAUNCHES_VPU_QUANT += 1
    return q, s


def vpu_ln(x: torch.Tensor) -> torch.Tensor:
    """fp32 x → the last block's LN without affine, bf16 [1024, 768]."""
    global LAUNCHES_VPU_LN
    if not x.is_cuda:
        return vpu_ln_reference(x)
    blocks = _grid_of(x, "x", torch.float32)
    y = torch.empty((M_BLOCK, K), dtype=torch.bfloat16, device=x.device)
    err = _build.launch("vit_probe_vpu", x, x.data_ptr(), 1, y.data_ptr(),
                        None, _row_scratch(blocks, x.device).data_ptr(), blocks)
    _build.check_launch(err, "probe vpu:ln")
    LAUNCHES_VPU_LN += 1
    return y


def mxu(xq: torch.Tensor, w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """int8 xq [blocks * 1024, 768] @ int8 w [768, n], times sw [1, n] →
    the last block's bf16 [1024, n]. On the card w is stored K-major."""
    global LAUNCHES_MXU
    if not xq.is_cuda:
        return mxu_reference(xq, w, sw)
    blocks = _grid_of(xq, "xq", torch.int8)
    n = _check_weights(w, sw, xq.device)
    o = torch.empty((M_BLOCK, n), dtype=torch.bfloat16, device=xq.device)
    grid = _gemm_grid(blocks, xq.device)
    err = _build.launch("vit_probe_mxu", xq, xq.data_ptr(), w.data_ptr(),
                        w.stride(1), sw.data_ptr(), o.data_ptr(),
                        _scratch(grid * _GEMM_WARPS, xq.device).data_ptr(),
                        blocks, n, grid)
    _build.check_launch(err, "probe mxu")
    LAUNCHES_MXU += 1
    return o


def fused(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """fp32 x quantized per row, then @ w, times its scale and sw → the last
    block's bf16 [1024, n]. On the card w is stored K-major."""
    global LAUNCHES_FUSED
    if not x.is_cuda:
        return fused_reference(x, w, sw)
    blocks = _grid_of(x, "x", torch.float32)
    n = _check_weights(w, sw, x.device)
    o = torch.empty((M_BLOCK, n), dtype=torch.bfloat16, device=x.device)
    grid = _gemm_grid(blocks, x.device)
    err = _build.launch("vit_probe_fused", x, x.data_ptr(), w.data_ptr(),
                        w.stride(1), sw.data_ptr(), o.data_ptr(),
                        _scratch(grid * _GEMM_WARPS, x.device).data_ptr(),
                        blocks, n, grid)
    _build.check_launch(err, "probe fused")
    LAUNCHES_FUSED += 1
    return o


def indep(xa: torch.Tensor, xqb: torch.Tensor, w: torch.Tensor,
          sw: torch.Tensor, vpu_op: str = "quant"):
    """The row work on fp32 xa beside the GEMM of int8 xqb, no dependency
    between them → the last block's (oq, os, o): ``vpu_op="quant"`` int8 oq
    and fp32 scales os; ``"ln"`` bf16 oq and os = xa's first column. On
    the card w is stored K-major."""
    global LAUNCHES_INDEP_QUANT, LAUNCHES_INDEP_LN
    _check_vpu_op(vpu_op)
    if not xa.is_cuda:
        return indep_reference(xa, xqb, w, sw, vpu_op)
    blocks = _grid_of(xa, "xa", torch.float32)
    if _grid_of(xqb, "xqb", torch.int8) != blocks:
        raise ValueError(f"xa and xqb have other row counts: {xa.shape[0]}, "
                         f"{xqb.shape[0]}")
    n = _check_weights(w, sw, xa.device)
    ln = vpu_op == "ln"
    oq = torch.empty((M_BLOCK, K), dtype=torch.bfloat16 if ln else torch.int8,
                     device=xa.device)
    os_ = torch.empty((M_BLOCK, 1), dtype=torch.float32, device=xa.device)
    o = torch.empty((M_BLOCK, n), dtype=torch.bfloat16, device=xa.device)
    grid = _gemm_grid(blocks, xa.device)
    err = _build.launch("vit_probe_indep", xa, xa.data_ptr(), xqb.data_ptr(),
                        w.data_ptr(), w.stride(1), sw.data_ptr(), int(ln),
                        oq.data_ptr(), os_.data_ptr(), o.data_ptr(),
                        _scratch(grid * _INDEP_WARPS, xa.device).data_ptr(),
                        blocks, n, grid)
    _build.check_launch(err, f"probe indep ({vpu_op})")
    if ln:
        LAUNCHES_INDEP_LN += 1
    else:
        LAUNCHES_INDEP_QUANT += 1
    return oq, os_, o


class Form(NamedTuple):
    """One launch form: its wrapper and plain version, the operands they
    take (``xf`` fp32 x, ``xq`` int8 x, ``w``, ``sw``) and any trailing
    argument, and the name of its launch counter."""
    wrapper: Callable
    reference: Callable
    args: tuple
    extra: tuple
    counter: str


_GEMM = ("w", "sw")
FORMS = {
    "stream": Form(stream, stream_reference, ("xf",), (), "LAUNCHES_STREAM"),
    "vpu:q": Form(vpu_quant, vpu_quant_reference, ("xf",), (),
                  "LAUNCHES_VPU_QUANT"),
    "vpu:ln": Form(vpu_ln, vpu_ln_reference, ("xf",), (), "LAUNCHES_VPU_LN"),
    "mxu": Form(mxu, mxu_reference, ("xq",) + _GEMM, (), "LAUNCHES_MXU"),
    "fused": Form(fused, fused_reference, ("xf",) + _GEMM, (), "LAUNCHES_FUSED"),
    "indep:q": Form(indep, indep_reference, ("xf", "xq") + _GEMM, ("quant",),
                    "LAUNCHES_INDEP_QUANT"),
    "indep:ln": Form(indep, indep_reference, ("xf", "xq") + _GEMM, ("ln",),
                     "LAUNCHES_INDEP_LN"),
}


def run(form: str, operands: dict, plain: bool = False) -> list:
    """One call of ``form`` (its wrapper, or its plain version) on the
    operands named in ``FORMS``; its outputs as a list."""
    f = FORMS[form]
    out = (f.reference if plain else f.wrapper)(
        *(operands[a] for a in f.args), *f.extra)
    return list(out) if isinstance(out, tuple) else [out]


# --- data, bounds and timing --------------------------------------------


def _x_f32(rows: int, salt: int, device="cpu") -> torch.Tensor:
    """[rows, K] fp32, the same in every row: ((col * 16807 + salt) % 251)
    * 0.013 - 1.6 with fp32 constants, rounded once as JAX's fused
    multiply-add does (the product is exact in float64)."""
    col = torch.arange(K, dtype=torch.int64, device=device)
    v = ((col * 16807 + salt) % 251).double()
    row = (v * _F32_0_013 - _F32_1_6).float()
    return row.expand(rows, K).contiguous()


def _x_i8(rows: int, salt: int, device="cpu") -> torch.Tensor:
    """[rows, K] int8, constant along each row: ((row * 16807 + salt) %
    251) - 125 with JAX's int32 arithmetic, which wraps from row 127,774 on
    (then the floor remainder of a negative number)."""
    i = torch.arange(rows, dtype=torch.int64, device=device)
    v = (i * 16807 + salt) & 0xFFFFFFFF
    v = torch.where(v >= 2**31, v - 2**32, v)  # int32's two's complement
    v = torch.remainder(v, 251) - 125
    return v.to(torch.int8)[:, None].expand(rows, K).contiguous()


def _weights_row_major(device="cpu"):
    """The JAX script's w int8 [K, N], constant along N, row-major."""
    return _x_i8(K, 3, device)[:, :1].expand(K, N).clamp(-125, 125).contiguous()


def weights(device="cpu"):
    """main()'s (w int8 [K, N], constant along N, stored K-major: the
    layout the GEMM kernels read, one copy of the JAX script's row-major w;
    sw fp32 [1, N] = 3e-4)."""
    return (k_major(_weights_row_major(device)),
            torch.full((1, N), 3e-4, dtype=torch.float32, device=device))


def bound(nbytes: float, int8_ops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the int8 operations over their peak. The kernels'
    elementwise fp32 work lies below both."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, int8_ops / PEAK_INT8
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def work(form: str, rows: int) -> tuple:
    """(bytes, int8 operations) of one launch of ``form`` over ``rows``
    rows and N columns: each input read once, each output (one block)
    written once."""
    xf, xq, wb = rows * K * 4, rows * K, K * N + N * 4
    gemm = 2 * rows * K * N
    out_gemm = M_BLOCK * N * 2
    return {
        "stream": (xf + 8 * 128 * 4, 0),
        "vpu:q": (xf + M_BLOCK * (K + 4), 0),
        "vpu:ln": (xf + M_BLOCK * K * 2, 0),
        "mxu": (xq + wb + out_gemm, gemm),
        "fused": (xf + wb + out_gemm, gemm),
        "indep:q": (xf + xq + wb + M_BLOCK * (K + 4) + out_gemm, gemm),
        "indep:ln": (xf + xq + wb + M_BLOCK * (2 * K + 4) + out_gemm, gemm),
    }[form]


def _call(fn: Callable, device: torch.device) -> float:
    """Best-of-``REPS`` seconds a call, each rep timing ``CHAIN``
    back-to-back launches: CUDA events on the card, the host clock on the
    CPU (the plain versions)."""
    fn()  # build and warm
    best = float("inf")
    for _ in range(REPS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CHAIN):
                fn()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(CHAIN):
                fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / CHAIN


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    if device.type != "cuda":
        return "card: none (device cpu: the plain versions' host times)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[device.index or 0] \
            if smi.stdout.strip() else smi.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        line = f"nvidia-smi unavailable ({exc})"
    return f"card: {line}"


def main(argv=None, device=None) -> dict:
    """Run the probe; returns each form's ms a call."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    print(card_line(dev), flush=True)

    rows = GRID * M_BLOCK
    w_row_major = _weights_row_major(dev)
    t_copy = _call(lambda: k_major(w_row_major), dev)
    print(f"w K-major copy  (weights(), before the chains): {t_copy * 1e3:7.4f} ms",
          flush=True)
    w, sw = weights(dev)
    ops = dict(xf=_x_f32(rows, 7, dev), xq=_x_i8(rows, 11, dev), w=w, sw=sw)
    gemm_tops = 2 * rows * K * N / 1e12

    times = {}
    for form, label in (("stream", "stream  (f32 in, touch):            "),
                        ("vpu:q", "vpu:q   (quantize rows only):       "),
                        ("vpu:ln", "vpu:ln  (layernorm only):           "),
                        ("mxu", "mxu     (int8 GEMM only):           "),
                        ("fused", "fused   (quantize->GEMM, prod W8A8):")):
        t = times[form] = _call(lambda: run(form, ops), dev)
        b_ms, b_by = bound(*work(form, rows))
        rate = f" ({gemm_tops / t:6.1f} TOPS)" if form in ("mxu", "fused") else ""
        print(f"{label}{t * 1e3:7.3f} ms{rate}  [bound {b_ms:.4f} ms, {b_by}]",
              flush=True)

    t_mxu = times["mxu"]
    for form, vpu in (("indep:q", "vpu:q"), ("indep:ln", "vpu:ln")):
        t_ind = times[form] = _call(lambda: run(form, ops), dev)
        hi = times[vpu] + t_mxu
        lo = max(times[vpu], t_mxu)
        frac = (hi - t_ind) / max(hi - lo, 1e-9)
        b_ms, b_by = bound(*work(form, rows))
        print(f"indep   ({vpu} || mxu):            {t_ind * 1e3:7.3f} ms  "
              f"[serial={hi * 1e3:.3f}, max={lo * 1e3:.3f} -> "
              f"overlap {frac * 100:5.1f}%] [bound {b_ms:.4f} ms, {b_by}]",
              flush=True)

    t_fused = times["fused"]
    print(f"\nfused vs mxu+vpu:q serial sum: {t_fused / (times['vpu:q'] + t_mxu):.3f}x; "
          f"fused vs mxu alone: {t_fused / t_mxu:.3f}x", flush=True)
    return {form: t * 1e3 for form, t in times.items()}


if __name__ == "__main__":
    main()

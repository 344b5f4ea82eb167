"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` (Hopper; the ``a`` keeps
``wgmma`` and ``setmaxnreg`` available), one ``nvcc`` process per source, all
started together, then linked into one shared library with a plain C
interface. The library lands in ``vit_with_opencl_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so an unchanged tree loads
the earlier build and an edited one rebuilds. Nothing here runs at import:
the build happens at the first kernel launch, so the CPU tests import every
module on a machine with no CUDA toolkit.

There is no fallback. Without ``nvcc``, or when a compile fails, ``library()``
raises a ``RuntimeError`` that carries the compiler's messages; the kernel
wrappers never swap in their plain PyTorch versions for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# Hidden by default: only the VIT_EXPORT entry points leave the library. Two
# builds loaded in one process (before_after.py's library swap) then keep
# their own host state; with default visibility the static locals of the
# headers' inline functions (the tensor-map cache, the GEMM's per-device
# flags) are process-wide unique symbols that the two would share.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xcompiler", "-fvisibility=hidden"]

# dtype codes of csrc/common.cuh (vit::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)  # a host array of int64 (strides)
# name -> argtypes; every entry point returns its cudaError_t as an int.
SIGNATURES = {
    # x, x_dtype, w, b, y, y_dtype, rows, cols, eps, stream
    "vit_layernorm": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _P],
    # x, x_dtype, r, r_dtype, w, b, y, summed, rows, cols, eps, stream
    "vit_layernorm_residual": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    # x, w, bias, residual, residual_kind, out, out_bf16, gelu, M, N, K, stream
    "vit_linear_bf16": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # x, w (int8), w_scale, bias, residual, residual_kind, out, out_bf16,
    # gelu, M, N, K, stream
    "vit_linear_int8w": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # xq, x_scale, w (int8, K-major), ldw, w_scale, x_hi, w_hi, K_hi, bias,
    # residual, residual_kind, out, out_bf16, gelu, M, N, K, stream
    "vit_linear_w8a8": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I,
                        _I, _I, _I, _I, _P],
    # qkv, out, B, T, num_heads, head_dim, scale, stream
    "vit_packed_attention_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, out, B, T, kv_len, num_heads, head_dim, per_head, scale, stream
    "vit_packed_attention_kv": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, x_dtype, q, scale, rows, cols, stream
    "vit_quantize_rows": [_P, _I, _P, _P, _I, _I, _P],
    # x (fp32), q, scale, hi (bf16), rows, cols, m, stream
    "vit_quantize_rows_split": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x (bf16), q, scale, hi (bf16), rows, cols, head_dim, kh, stream
    "vit_quantize_rows_masked": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # qkv, dout, dqkv, dqkv_dtype, stats, B, T, num_heads, head_dim,
    # q_scale, ds_scale, stream
    "vit_packed_attention_bwd": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _F, _P],
    # qkv, out, lse (or NULL), B, T, kv_len, num_heads, head_dim, scale,
    # stream
    "vit_flash_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, out, lse (or NULL), strides (12), B, T, num_heads, head_dim,
    # scale, stream
    "vit_flash_attention_fwd_strided": [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                        _I, _F, _P],
    # q, k, v, out, dtype, strides (12), B, num_heads, T, kv_len, head_dim,
    # scale, stream
    "vit_single_pass_attention": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I,
                                  _F, _P],
    # qkv, out, lse, dout, dqkv, dvec, B, T, num_heads, head_dim, scale,
    # stream
    "vit_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # a, a_trans, b, b_trans, bias, gelu_grad_of, out, out_bf16, out2,
    # out2_gelu, M, N, K, full, splits, split_k, workspace, stream
    "vit_gemm_grad": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P],
    # x, x_dtype, dy, w, g, g_dtype, dx, dx_dtype, part_dw, part_db, rows,
    # cols, blocks, eps, stream
    "vit_layernorm_bwd": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                          _F, _P],
    # x, x_dtype, out, partial, rows, cols, rows_per_chunk, stream
    "vit_column_sum": [_P, _I, _P, _P, _I, _I, _I, _P],
    # q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, dtype, n,
    # t_loc, head_dim, block_k, scale, stream
    "vit_ring_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _F, _P],
    # The overlap probe (csrc/probe_overlap.cu): x, o, scratch, blocks, stream
    "vit_probe_stream": [_P, _P, _P, _I, _P],
    # x, ln, out, scale, scratch, blocks, stream
    "vit_probe_vpu": [_P, _I, _P, _P, _P, _I, _P],
    # xq (or x for fused), w, sw, o, scratch, blocks, n, stream
    "vit_probe_mxu": [_P, _P, _P, _P, _P, _I, _I, _P],
    "vit_probe_fused": [_P, _P, _P, _P, _P, _I, _I, _P],
    # xa, xqb, w, sw, ln, oq, os, o, scratch, blocks, n, stream
    "vit_probe_indep": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` or the default
    toolkit directory; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or DEFAULT_CUDA_HOME
    candidate = os.path.join(home, "bin", "nvcc")
    return candidate if os.path.isfile(candidate) else None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_key() -> str:
    """Hash of every source and header and of the flags: the build's name."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/`` into the keyed shared library (once) and return
    its path."""
    lib_path = BUILD_DIR / f"libvit_kernels_{source_key()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use, which needs the CUDA toolkit's nvcc on PATH or under "
            f"$CUDA_HOME/bin (default {DEFAULT_CUDA_HOME})")
    work = BUILD_DIR / f"tmp_{lib_path.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for src, _obj, proc in jobs:
            _out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {src.name} (exit {proc.returncode}):\n{err}")
        if failures:
            raise RuntimeError("nvcc failed to compile the port's kernels:\n"
                               + "\n".join(failures))
        tmp_lib = work / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _src, obj, _proc in jobs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the port's kernels:\n"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a reader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def resource_usage(source: str) -> list[dict]:
    """Each kernel of ``csrc/<source>`` as ptxas compiles it with the build's
    flags (``nvcc -Xptxas -v``): its name (demangled where the toolkit's
    ``cu++filt`` is found), registers a thread, and bytes of spill stores
    and loads. Needs ``nvcc``; builds nothing that ``library()`` loads."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: ptxas reports need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"resource_usage_{os.getpid()}.o"
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               str(CSRC_DIR / source), "-o", str(obj)],
                              capture_output=True, text=True)
    finally:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    kernels: list[dict] = []
    for line in proc.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            kernels.append({"name": found.group(1), "registers": None,
                            "spill_stores": None, "spill_loads": None})
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and kernels:
            kernels[-1]["spill_stores"] = int(found.group(1))
            kernels[-1]["spill_loads"] = int(found.group(2))
        found = re.search(r"Used (\d+) registers", line)
        if found and kernels:
            kernels[-1]["registers"] = int(found.group(1))
    filt = Path(nvcc).with_name("cu++filt")
    if filt.is_file() and kernels:
        names = subprocess.run([str(filt)], input="\n".join(k["name"] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, name in zip(kernels, names):
                k["name"] = name
    return kernels


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vit_error_string.argtypes = [ctypes.c_int]
        lib.vit_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel's entry point returned a CUDA error."""
    if err != 0:
        msg = library().vit_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(name: str, t: torch.Tensor, *args) -> int:
    """Call entry point ``name`` with ``args`` and PyTorch's current stream
    on ``t``'s device, with that device made current around the call.

    The entry points launch through the CUDA runtime, which works on the
    calling thread's current device: its null stream (the handle of
    PyTorch's default stream is 0) and its per-device kernel attributes.
    Without the guard a tensor on ``cuda:1`` would be read by a kernel on
    ``cuda:0`` that does not wait for ``cuda:1``'s stream. Returns the
    entry point's cudaError_t."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        return getattr(library(), name)(*args, stream)


def head_strides(*views: torch.Tensor):
    """The (image, head, row) element strides of each [B, H, T, hd] view in
    turn, as the strided attention entries take them (a host int64 array)."""
    values = [st for v in views for st in v.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def require_head_view(t: torch.Tensor, name: str, *, device: torch.device,
                      dtypes: tuple) -> None:
    """Check a [B, H, T, hd] view that a strided attention kernel reads or
    writes: device, dtype, a contiguous last axis, and 16-byte rows (every
    stride and the base address 16-byte aligned)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, H, T, hd] with a contiguous last "
                         f"axis, got shape {tuple(t.shape)} strides {t.stride()}")
    per16 = 16 // t.element_size()
    if any(st % per16 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies 16-byte rows, so every "
                         f"stride must be a multiple of {per16} elements and "
                         f"the base 16-byte aligned, got strides {t.stride()}")


def refuse_autograd(what: str, tensors, trainable: str) -> None:
    """Raise where a kernel would cut the autograd graph: grad mode on and
    an input or weight that requires grad. The kernels write their results
    through raw pointers, so the result would carry no graph and the
    weights behind it would silently get no gradient (the JAX package
    raises for a ``pallas_call`` without a VJP). ``torch.no_grad`` and
    ``torch.inference_mode`` pass. ``tensors`` may hold dicts (quantized
    weights) and None."""
    if not torch.is_grad_enabled():
        return
    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{what} has no backward: on the card it runs a kernel whose "
                f"result carries no autograd graph. Use {trainable} to train "
                "through it, or run it under torch.no_grad() or "
                "torch.inference_mode()")


def require(t: torch.Tensor, name: str, *, device: torch.device,
            dtypes: tuple, shape: Optional[tuple] = None) -> None:
    """Check what a kernel takes: device, dtype, shape, contiguity and the
    16-byte alignment of its vector loads."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")

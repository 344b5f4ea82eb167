"""Kernel autotuning on the card: time each candidate of a launch knob and
cache the winner per (config, batch, dtype[, quant]).

Counterpart of ``vit_with_opencl_tpu/perf/autotune.py``. JAX's knobs
describe the TPU's grid: images per grid cell (``attention_ipc``,
``attention_bwd_ipc``, ``fused_block_ipc``, ``fused_stack_ipc``), the
ragged or padded route (``attention_ragged``), the GEMM's block shapes, and
the blockwise kernel's ``(block_q, block_k)``. The Hopper kernels run on a
persistent grid, with no images per cell and no ragged route, and the GEMM
core's tile is fixed; so the port has one knob, the blockwise forward's key
tile ``block_k`` (``ops/attention.FLASH_BLOCK_KS``: 128, 256, 512), swept
where the config's sequence passes ``SINGLE_PASS_MAX_T`` and the encoder
takes the blockwise route, in bf16 or fp32 (the forward's fp32 form takes
the same tiles). It is part of the function (p is rounded to bf16 against
the running max of each ``block_k``-key tile; in fp32 the tile sets where
the max moves and the order of the sums), so a tuned engine computes what
JAX computes at that ``block_k``; ``block_q`` moves nothing and is not
swept. JAX's grid knobs raise ``ValueError`` by name, here, in
``models/vit.resolve_kernels`` and in ``parallel/spmd.make_train_step``;
``tune_fused_linear_blocks`` raises ``NotImplementedError``.

The cache is a JSON file of {key: entry}, ``tuning_key``'s key strings
being JAX's. The port keeps its own file (``VIT_TORCH_TUNING``, default
``~/.cache/vit_torch_tuning.json``): an entry records the device it was
measured on (the card's name, or ``cpu``), and ``lookup`` ignores an entry
from another device. ``InferenceEngine`` and ``DataParallelEngine`` read
the entry of their batch at construction, ``Trainer(batch_size=)`` the
``train`` entry.

On the card: ``python -m vit_with_opencl_tpu_torch.perf.autotune --config
vit_l_16_384 --img-size 512 --batch 16``. With ``device="cpu"`` the sweep
times the plain versions (mechanics only; no entry from it is honoured on
the card).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ViTConfig
from ..engine import resolve_device
from ..ops import attention

# The knobs that ``tune_and_save`` sweeps, and JAX's sweeps that set its
# grid knobs, refused by name.
ALL_KNOBS = ("blockwise",)
JAX_GRID_SWEEPS = ("attention", "attention_bwd", "ragged", "ipc")
TUNING_ENV = "VIT_TORCH_TUNING"


def time_fn(fn: Callable, args: tuple, iters: int = 20) -> float:
    """Best-of-3 mean ms a call of ``fn`` (which returns a tensor, or a
    tuple whose first item is one). A result on the card is timed by CUDA
    events around ``iters`` calls and a synchronise; one on the CPU by the
    host clock."""
    out = fn(*args)
    leaf = out[0] if isinstance(out, tuple) else out
    on_card = leaf.is_cuda
    best = float("inf")
    for _ in range(3):
        if on_card:
            torch.cuda.synchronize(leaf.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def sweep(
    candidates: Iterable,
    build: Callable[[object], Callable],
    args: tuple,
    *,
    iters: int = 20,
    timer: Optional[Callable] = None,
    prior: Optional[Dict] = None,
    budget: Optional[list] = None,
    on_point: Optional[Callable[[Dict], None]] = None,
) -> Tuple[object, Dict]:
    """Time ``build(candidate)`` for each candidate; return (best, table).

    A candidate whose build or launch fails is recorded as inf and printed:
    a data point, not an error. ``prior``: {candidate: ms} measured earlier,
    skipped here. ``budget``: a one-element list of the new measurements
    this call may take (shared across knobs by ``tune_and_save(points=)``);
    when it runs out the partial table comes back with best None.
    ``on_point(table)`` runs after every new measurement (``tune_and_save``
    writes the cache through, so a killed run keeps what it measured). As
    JAX's ``sweep``."""
    timer = timer or time_fn
    candidates = list(candidates)
    if not candidates:
        raise ValueError("no candidates to sweep")
    table: Dict = dict(prior) if prior else {}
    for cand in candidates:
        if cand in table:
            continue
        if budget is not None:
            if budget[0] <= 0:
                return None, table  # out of measurements: partial
            budget[0] -= 1
        try:
            fn = build(cand)
            table[cand] = timer(fn, args, iters)
        except Exception as exc:  # noqa: BLE001 — a failed candidate is a data point
            print(f"autotune: candidate {cand!r} failed ({type(exc).__name__}: "
                  f"{str(exc).splitlines()[0] if str(exc) else ''}); recorded as inf",
                  flush=True)
            table[cand] = float("inf")
        if on_point is not None:
            on_point(table)
    best = min(table, key=table.get)
    if table[best] == float("inf"):
        raise RuntimeError(f"every candidate failed: {table}")
    return best, table


def _seeded(shape: tuple, salt: int, dtype: torch.dtype, device) -> torch.Tensor:
    """JAX's sweep inputs (``tune_blockwise_blocks``' ``mk``): element i of
    the flat array is ``((i * 48271 + salt) % 1021) / 1021 - 0.5``, the
    product taken in int32 with its wrap-around, as ``broadcasted_iota`` in
    int32 gives it."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device) * 48271 + salt
    i = (i + 2**31) % 2**32 - 2**31  # int32 wrap-around
    v = torch.remainder(i, 1021).to(torch.float32) / 1021.0 - 0.5
    return v.reshape(shape).to(dtype)


def tune_blockwise_blocks(
    seq_len: int,
    head_dim: int,
    *,
    batch_heads: int = 8,
    dtype: torch.dtype = torch.bfloat16,
    candidates: Sequence[int] = attention.FLASH_BLOCK_KS,
    iters: int = 10,
    timer: Optional[Callable] = None,
    prior: Optional[Dict] = None,
    budget: Optional[list] = None,
    on_point: Optional[Callable[[Dict], None]] = None,
    device=None,
) -> Tuple[int, Dict]:
    """Sweep the blockwise forward's key tile ``block_k`` at ``seq_len``:
    the candidates up to ``seq_len``, a table keyed by ``block_k``. The
    inputs are JAX's seeded pattern (q, k and v with salts 1, 2 and 3), as
    ``batch_heads`` (image, head) pairs of ``head_dim`` in the slabs of
    ``blockwise_attention_fwd`` (one head an image), the route the engines'
    attention link launches; all ``seq_len`` keys attend."""
    dev = resolve_device(device)
    d = head_dim
    q, k, v = (_seeded((batch_heads, seq_len, d), salt, dtype, dev) for salt in (1, 2, 3))
    qkv = torch.cat([q, k, v], dim=-1).contiguous()
    del q, k, v

    def build(block_k):
        def run():
            with torch.inference_mode():
                return attention.blockwise_attention_fwd(qkv, 1, head_dim,
                                                         block_k=block_k)[0]
        return run

    valid = [c for c in candidates if c <= seq_len]
    return sweep(valid, build, (), iters=iters, timer=timer, prior=prior,
                 budget=budget, on_point=on_point)


def tune_fused_linear_blocks(*args, **kwargs):
    """JAX sweeps its GEMM's (block_m, block_n, block_k); the port's GEMMs
    run on one Hopper core whose tile is fixed (``csrc/gemm_sm90.cuh``:
    128 x 128 output tiles, 64-deep slices), so there is nothing to sweep."""
    raise NotImplementedError(
        "tune_fused_linear_blocks: the Hopper GEMM core's tile is fixed at 128 "
        "x 128 (csrc/gemm_sm90.cuh); it has no block shapes to sweep")


# ---------------------------------------------------------------------------
# The tuning cache
# ---------------------------------------------------------------------------


def default_tuning_path() -> str:
    return os.environ.get(
        TUNING_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "vit_torch_tuning.json"))


def _dtype_name(dtype) -> str:
    """"bfloat16" or "float32" (JAX's ``jnp.dtype(dtype).name``) for a torch
    dtype or a name."""
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def tuning_key(config: ViTConfig, batch: int, dtype,
               quant: Optional[str] = None) -> str:
    """JAX's key string: ``"{name}|b{batch}|{dtype}"`` and ``"|{quant}"``."""
    base = f"{config.name}|b{int(batch)}|{_dtype_name(dtype)}"
    return f"{base}|{quant}" if quant else base


def device_identity(device=None) -> str:
    """The name a cache entry records: the card's
    (``torch.cuda.get_device_name``) or ``cpu``. ``device`` None means the
    card where there is one."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def lookup(config: ViTConfig, batch: int, dtype,
           path: str | os.PathLike | None = None,
           quant: Optional[str] = None, device=None) -> Dict:
    """The saved tuning for this (config, batch, dtype[, quant]), or {}.

    A quantized or training lookup with no entry of its own takes the
    unquantized entry, tagged ``"fallback_from": <its key>``. An entry
    recorded on another device than ``device``'s (``device_identity``) is
    ignored, and so is a malformed cache: this never raises. As JAX's."""
    try:
        entry = load_tuning(path or default_tuning_path(),
                            tuning_key(config, batch, dtype, quant))
        if entry is None and quant:
            base_key = tuning_key(config, batch, dtype)
            entry = load_tuning(path or default_tuning_path(), base_key)
            if isinstance(entry, dict):
                entry = {**entry, "fallback_from": base_key}
        entry = entry or {}
    except (OSError, ValueError, AttributeError, TypeError):
        return {}
    if not isinstance(entry, dict):
        return {}
    recorded = entry.get("device")
    if recorded is not None and recorded != device_identity(device):
        return {}
    return entry


def _parse_prior_table(entry: Dict, key: str) -> Optional[Dict]:
    """A persisted table ({str(candidate): ms}) with its candidates' types
    restored, for a resumed sweep; None if absent or unparseable."""
    tbl = entry.get(key)
    if not isinstance(tbl, dict):
        return None
    out: Dict = {}
    for k, v in tbl.items():
        try:
            out[ast.literal_eval(k)] = v
        except (ValueError, SyntaxError):
            return None
    return out


def save_tuning(path: str | os.PathLike, key: str, result: Dict) -> None:
    """Set ``key``'s whole entry in the cache at ``path`` (written to a
    temporary file and renamed, so a reader never sees half a file)."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    data[key] = result
    folder = os.path.dirname(str(path)) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tuning_", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_tuning(path: str | os.PathLike, key: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):  # a foreign file: no entries
        return None
    return data.get(key)


def _check_knobs(knobs: Sequence[str]) -> None:
    grid = sorted(set(knobs) & set(JAX_GRID_SWEEPS))
    if grid:
        raise ValueError(
            f"knobs {grid} sweep JAX's grid knobs (images per grid cell, the "
            f"ragged or padded route); the Hopper kernels run on a persistent "
            f"grid with neither, so the port sweeps {ALL_KNOBS} only")
    unknown = set(knobs) - set(ALL_KNOBS)
    if unknown:
        raise ValueError(f"unknown knobs {sorted(unknown)}; pick from {ALL_KNOBS}")


def tune_and_save(
    config: ViTConfig,
    batch: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    path: str | os.PathLike | None = None,
    iters: int = 20,
    timer: Optional[Callable] = None,
    quant: Optional[str] = None,
    knobs: Optional[Sequence[str]] = None,
    points: Optional[int] = None,
    device=None,
) -> Dict:
    """Sweep the knobs for this (config, batch, dtype[, quant]) on
    ``device`` (default the card, which must be there) and save the entry.

    ``knobs`` (default ``ALL_KNOBS``): "blockwise", the key tile, swept
    where ``config.num_tokens`` passes ``SINGLE_PASS_MAX_T``, over all
    ``batch * num_heads`` (image, head) pairs of a forward's attention (the
    persistent grid's share of the card is part of what is measured).
    JAX's grid sweeps raise ``ValueError`` by name, any other knob JAX's
    "unknown knobs". ``points`` caps the new measurements of this call;
    a knob's winner is written only once its table covers every candidate,
    and every point is written through as it is measured.

    A sweep of fewer knobs than the default, or with ``points``, is partial
    and merges into the entry already saved on this device; a default sweep
    replaces the entry whole, so that nothing its conditions now skip stays
    behind (JAX's ``tune_and_save`` treats its inference default, which
    lacks ``attention_bwd``, as partial and keeps stale knobs: the port does
    not).
    """
    dev = resolve_device(device)
    path = path or default_tuning_path()
    knobs = tuple(ALL_KNOBS if knobs is None else knobs)
    _check_knobs(knobs)
    if points is not None and points < 1:
        raise ValueError(f"points must be >= 1, got {points}")
    budget = [points] if points is not None else None
    key = tuning_key(config, batch, dtype, quant)
    result: Dict = {"device": device_identity(dev),
                    "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    if set(knobs) < set(ALL_KNOBS) or points is not None:
        prior = load_tuning(path, key)
        if isinstance(prior, dict) and prior.get("device") == result["device"]:
            result = {**prior, **result}

    def left() -> bool:
        return budget is None or budget[0] > 0

    def writer(table_key):
        def on_point(table):
            result[table_key] = {str(k): v for k, v in table.items()}
            save_tuning(path, key, result)
        return on_point

    if ("blockwise" in knobs and config.num_tokens > attention.SINGLE_PASS_MAX_T
            and left()):
        bk, table = tune_blockwise_blocks(
            config.num_tokens, config.head_dim,
            batch_heads=int(batch) * config.num_heads,
            dtype=dtype, iters=iters, timer=timer,
            prior=_parse_prior_table(result, "blockwise_table_ms"),
            budget=budget, on_point=writer("blockwise_table_ms"), device=dev)
        if bk is not None:
            result["blockwise_block_k"] = int(bk)
        result["blockwise_table_ms"] = {str(k): v for k, v in table.items()}
    save_tuning(path, key, result)
    return result


def _resized(config: ViTConfig, img_size: int) -> ViTConfig:
    """``config`` at another resolution, named as the repository names such
    configurations: the trailing resolution replaced (``vit_l_16_384`` at
    512 is ``vit_l_16_512``)."""
    base = re.sub(r"_\d+$", "", config.name)
    return dataclasses.replace(config, name=f"{base}_{img_size}", img_size=img_size)


def main(argv=None) -> int:
    """Sweep the port's launch knob on the card and save the tuning cache
    that InferenceEngine, DataParallelEngine, the serving daemon and
    Trainer(batch_size=) consult at start-up."""
    import argparse

    from ..config import PRESETS, get_config

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", default="vit_b_16_224", choices=sorted(PRESETS))
    parser.add_argument("--img-size", type=int, default=None,
                        help="the preset at another resolution (e.g. 512 on "
                             "vit_l_16_384: vit_l_16_512, 1025 tokens)")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--out", default=None,
                        help=f"tuning file (default ${TUNING_ENV} or "
                             f"~/.cache/vit_torch_tuning.json)")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--quant", default=None, choices=["int8", "int8-w8a8", "train"],
                        help="the entry of a quantized engine, or 'train' for "
                             "Trainer(batch_size=)")
    parser.add_argument("--knobs", default=None,
                        help=f"comma list of {ALL_KNOBS}; fewer than all merges "
                             f"into the saved entry")
    parser.add_argument("--points", type=int, default=None,
                        help="measure at most N new candidates this run and "
                             "merge into the cache")
    parser.add_argument("--device", default=None,
                        help="'cpu' times the plain versions (default: the card)")
    args = parser.parse_args(argv)
    cfg = get_config(args.config)
    if args.img_size is not None:
        cfg = _resized(cfg, args.img_size)
    dtype = getattr(torch, args.dtype)
    knobs = ([k.strip() for k in args.knobs.split(",") if k.strip()]
             if args.knobs is not None else None)
    result = tune_and_save(cfg, args.batch, dtype=dtype, path=args.out,
                           iters=args.iters, quant=args.quant, knobs=knobs,
                           points=args.points, device=args.device)
    print(json.dumps({tuning_key(cfg, args.batch, dtype, args.quant): result},
                     indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())

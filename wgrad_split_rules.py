#!/usr/bin/env python3
"""Time ``linear_wgrad``'s split-K choice on one card against two other
rules, at the presets' widths.

    python3 wgrad_split_rules.py

Run from the repository root on a machine with a card and the CUDA toolkit.
A weight gradient [K, N] has few 128 x 128 tiles against the SMs, so
``ops/linear._wgrad_splits`` runs the whole waves of tiles whole and splits
the token axis of the rest into the most runs that fit in one round of the
SMs. For every ViT-Ti/S/B, ViT-L/16@384 and ViT-H/14 GEMM form (qkv, out,
fc1, fc2) at a few batches where the first two below differ, this times
``linear_wgrad`` with three choices of (full, S, split_k):

* ``one round``: ``_wgrad_splits`` as the package has it;
* ``cost model``: the rule it replaced, kept here: each S priced as its
  rounds of units over the SMs times a unit's slices, plus the partials'
  bytes and the sum's launch, up to 4 waves of units;
* ``whole``: no split.

Prints one line a shape and, last, one JSON object with every time and the
geometric mean of cost model / one round over the shapes.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

try:
    from vit_with_opencl_tpu_torch.config import (VIT_B_16_224, VIT_H_14_224,
                                                  VIT_L_16_384, VIT_S_16_224,
                                                  VIT_TINY_16_224)
    from vit_with_opencl_tpu_torch.ops import _build, linear
except ImportError as exc:  # run outside the repository
    print(f"FAIL: the port's package is not importable here: {exc}")
    sys.exit(1)

SHAPES = ((VIT_TINY_16_224, (16, 64, 256)), (VIT_S_16_224, (16, 64, 256)),
          (VIT_B_16_224, (16, 64, 256)), (VIT_L_16_384, (8, 32)),
          (VIT_H_14_224, (16, 64, 256)))
REPS = 20


# The cost model's constants (us on an H100): one 64-deep slice of one tile
# on one SM, the bytes a microsecond of the partials' write and read-back,
# the sum kernel's launch; the most waves of split units.
SLICE_US, PARTIAL_BYTES_PER_US, SUM_LAUNCH_US, MAX_SPLIT_WAVES = 0.41, 3.0e6, 4.0, 4


def cost_model(m_tokens: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    tiles = linear._tiles(k, n)
    slices = -(-m_tokens // linear._TILE_K)
    best = (-(-tiles // sms) * slices * SLICE_US, tiles, 1, slices)
    full = tiles // sms * sms
    rest = tiles - full
    for s in range(2, slices // linear._MIN_SPLIT_SLICES + 1):
        if rest == 0 or rest * s > MAX_SPLIT_WAVES * sms:
            break
        chunk = -(-slices // s)
        if -(-slices // chunk) != s:  # the same runs as a smaller S
            continue
        cost = (full // sms * slices * SLICE_US
                + -(-rest * s // sms) * chunk * SLICE_US
                + 2 * s * rest * linear._TILE_MN ** 2 * 4 / PARTIAL_BYTES_PER_US
                + SUM_LAUNCH_US)
        if cost < best[0]:
            best = (cost, full, s, chunk)
    return best[1], best[2], best[3] * linear._TILE_K


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.library()
    sms = linear._sm_count(dev.index)
    package = linear._wgrad_splits
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for cfg, batches in SHAPES:
        d, h = cfg.embed_dim, cfg.hidden_dim
        for batch in batches:
            m = batch * cfg.num_tokens
            for form, k, n in (("qkv", d, 3 * d), ("out", d, d), ("fc1", d, h),
                               ("fc2", h, d)):
                tiles = linear._tiles(k, n)
                slices = -(-m // linear._TILE_K)
                choices = {"one round": package(m, k, n, sms),
                           "cost model": cost_model(m, k, n, sms),
                           "whole": (tiles, 1, slices * linear._TILE_K)}
                if choices["cost model"] == choices["one round"]:
                    continue
                x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                dy = (torch.randn((m, n), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
                ms = {}
                for rule, pick in choices.items():
                    linear._wgrad_splits = lambda *_a, _p=pick: _p
                    try:
                        ms[rule] = time_ms(lambda: linear.linear_wgrad(x, dy))
                    finally:
                        linear._wgrad_splits = package
                row = {"shape": f"{cfg.name} B={batch} {form}", "tiles": tiles,
                       "choices": choices, "ms": ms}
                rows.append(row)
                print(f"{row['shape']} ({tiles} tiles): "
                      + "; ".join(f"{r} {choices[r]} {ms[r]:.4f} ms" for r in choices),
                      flush=True)
                del x, dy
    ratios = [r["ms"]["cost model"] / r["ms"]["one round"] for r in rows]
    geo = math.exp(sum(map(math.log, ratios)) / len(ratios)) if ratios else 1.0
    print(f"cost model / one round: geometric mean {geo:.4f} over {len(rows)} shapes "
          f"(min {min(ratios, default=1):.4f}, max {max(ratios, default=1):.4f})")
    print(json.dumps({"card": smi.stdout.strip(), "sms": sms, "rows": rows,
                      "cost_model_over_one_round_geomean": geo}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Generate a complete reference-format workspace: weights + inputs + answers.

Counterpart of ``scripts/make_fixtures.py``, on the port's copies of
``config``, ``harness/fixtures``, ``harness/results``, ``io/binfmt`` and
``models/golden``: deterministic synthetic weights in the exact
``Weight_<idx>_<name>.bin`` format, a packed ``input-<n>.bin``, and golden
``answer_result.txt`` from the fp32 oracle, so the end-to-end workflow
(load → run → emit → compare) is reproducible from a clean checkout. The
files are the JAX script's, byte for byte: both are made on the host with
NumPy. The device is checked as every script of the port checks it (the
card unless ``device="cpu"``), though nothing here runs on it.

Usage:
  python -m vit_with_opencl_tpu_torch.scripts.make_fixtures --out /tmp/ws \\
      --config vit_b_16_224 --images 8
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import config as config_lib
from ..engine import resolve_device
from ..harness import fixtures, results
from ..io import binfmt
from ..models import golden


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="vit_b_16_224",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--images", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=0.02)
    args = p.parse_args(argv)
    resolve_device(device)

    cfg = config_lib.get_config(args.config)
    os.makedirs(args.out, exist_ok=True)
    params = fixtures.random_params(cfg, seed=args.seed, scale=args.scale)
    images = fixtures.random_images(cfg, n=args.images, seed=args.seed + 1)

    binfmt.save_weights(
        os.path.join(args.out, "Network"),
        fixtures.params_to_positional(params, cfg),
        cfg,
    )
    input_path = os.path.join(args.out, f"input-{args.images}.bin")
    binfmt.save_image_data(input_path, images)

    # Golden answers from weights exactly as the loader will see them
    # (6-decimal rounding applied, reference: Network.c:208-211).
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    if cfg.head_type == "none":
        print("head_type='none' tower: no classification answers to emit")
    else:
        probs = golden.golden_forward(images, rounded, cfg)
        answer_path = os.path.join(args.out, "answer_result.txt")
        results.write_results(answer_path, probs)
        print(f"answers: {answer_path}")
    print(f"weights: {args.out}/Network ({len(binfmt.weight_names(cfg))} files)")
    print(f"inputs:  {input_path} ({args.images} images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end inference: the reference's ``main()`` as a CLI.

Counterpart of ``vit_with_opencl_tpu/cli.py``. Pipeline (reference:
Main.c:16-92): load the packed input binary → load the weight directory →
run a backend over all images → per-image argmax → write
``[i] label: L / prob: P`` result lines → compare against the answer file.
``golden`` is the fp32 NumPy oracle; ``gpu`` is the PyTorch engine, on the
card by default (``--device cpu`` runs its plain versions on the CPU).

    python -m vit_with_opencl_tpu_torch.cli --input input.bin --weights Network \
        --output result.txt --answer answer.txt --backend gpu --attention flash

Exit code 0, or 1 when the comparator finds mismatches.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import config as config_lib
from .harness import results
from .io import binfmt
from .io.labels import IMAGENET_LABELS


def _run_backend(backend: str, images: np.ndarray, params, cfg,
                 batch_size: int, attention: str, device: str) -> np.ndarray:
    if backend == "golden":
        from .models import golden

        return golden.golden_forward(images, params, cfg)
    from .engine import InferenceEngine

    engine = InferenceEngine(cfg, params, batch_size=batch_size,
                             attention_impl=attention, device=device)
    return engine.run(images)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", default="./Data/input-100.bin",
                        help="packed image binary (header + NCHW fp32)")
    parser.add_argument("--weights", default="./Network",
                        help="directory of Weight_<idx>_<name>.bin files")
    parser.add_argument("--output", default="./Data/opencl_result.txt",
                        help="result file to write")
    parser.add_argument("--answer", default=None,
                        help="golden answer file to compare against (optional)")
    parser.add_argument("--label-file", default=None,
                        help="ground-truth labels (one class id per line): "
                        "report top-1/top-5 accuracy")
    parser.add_argument("--backend", choices=["golden", "gpu"], default="gpu")
    parser.add_argument("--config", default="vit_b_16_224",
                        choices=sorted(config_lib.PRESETS))
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--attention", choices=["xla", "flash"], default="xla",
                        help="plain PyTorch ops, or the CUDA kernels (the "
                        "encoder-layer chain and packed attention)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the gpu backend; cpu runs every "
                        "kernel's plain PyTorch version")
    parser.add_argument("--no-round-weights", action="store_true",
                        help="skip the reference's 6-decimal weight rounding")
    parser.add_argument("--print-labels", action="store_true",
                        help="also print human-readable class names")
    args = parser.parse_args(argv)

    cfg = config_lib.get_config(args.config)

    t0 = time.perf_counter()
    images = binfmt.load_image_data(args.input)
    weights = binfmt.load_weights(
        args.weights, cfg, round_to_6dp=not args.no_round_weights, strict=True
    )
    params = binfmt.weights_to_dict(weights, cfg)
    t_load = time.perf_counter() - t0
    print(f"loaded {images.shape[0]} images + {len(weights)} weights "
          f"in {t_load:.2f}s (numpy io)")

    print("=====================Start========================")
    t0 = time.perf_counter()
    probs = _run_backend(args.backend, images, params, cfg, args.batch_size,
                         args.attention, args.device)
    elapsed = time.perf_counter() - t0
    n = images.shape[0]
    print(f"Elapsed time: {elapsed:.4f} sec ({n / elapsed:.2f} images/sec)")

    preds = results.write_results(args.output, probs)
    if args.print_labels:
        for i, (label, prob) in enumerate(preds):
            print(f"[{i}] {IMAGENET_LABELS[label]} ({label}): {prob:.6f}")

    if args.label_file:
        acc = results.evaluate_accuracy(
            probs, results.load_label_file(args.label_file)
        )
        print(f"accuracy: top-1 {acc['top1']*100:.2f}%  "
              f"top-5 {acc['top5']*100:.2f}%  (n={acc['n']})")

    if args.answer:
        errors = results.compare_result_files(args.output, args.answer)
        if errors == 0:
            print("Comparator: files match.")
        else:
            print(f"Comparator: {errors} mismatches.")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

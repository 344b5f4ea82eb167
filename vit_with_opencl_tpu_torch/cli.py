"""End-to-end inference: the reference's ``main()`` as a CLI.

Counterpart of ``vit_with_opencl_tpu/cli.py``. Pipeline (reference:
Main.c:16-92): load the packed input binary → load the weight directory →
run a backend over all images → per-image argmax → write
``[i] label: L / prob: P`` result lines → compare against the answer file.
``golden`` is the fp32 NumPy oracle; ``gpu`` is the PyTorch engine, on the
card by default (``--device cpu`` runs its plain versions on the CPU).

    python -m vit_with_opencl_tpu_torch.cli --input input.bin --weights Network \
        --output result.txt --answer answer.txt --backend gpu --attention flash \
        [--quantize int8|int8-w8a8|auto] [--calibrate CALIB.bin]

Images, weights and the calibration set load through libvitio (``runtime``,
compiled with g++ at first use) unless ``--pure-python`` asks for the NumPy
io layer or there is no toolchain; the ``loaded ...`` line says which ran.
``--raw-images a.jpg b.png ...`` preprocesses image files (torchvision's
resize, center crop and normalization; ``io/preprocess``) instead of reading
``--input``.

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
                 batch_size: int, attention: str, device: str,
                 quantize=None, calibrate=None) -> np.ndarray:
    if backend == "golden":
        from .models import golden

        return golden.golden_forward(images, params, cfg)
    from .engine import InferenceEngine

    engine = InferenceEngine(cfg, params, batch_size=batch_size,
                             attention_impl=attention, device=device,
                             quantize=quantize, calibrate=calibrate)
    return engine.run(images)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", default="./Data/input-100.bin",
                        help="packed image binary (header + NCHW fp32)")
    parser.add_argument("--raw-images", nargs="+", default=None,
                        help="raw image files (jpg/png/...): preprocess with "
                        "torchvision semantics instead of reading --input")
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
    parser.add_argument("--attention", choices=["xla", "flash", "fused_block"],
                        default="xla",
                        help="plain PyTorch ops, or the CUDA kernels (the "
                        "encoder-layer chain and packed attention); "
                        "fused_block is a synonym of flash")
    parser.add_argument("--quantize", choices=["int8", "int8-w8a8", "auto"],
                        default=None,
                        help="int8 quantization for the gpu backend: weight-"
                        "only (int8 weights into the bf16 GEMM) or w8a8 "
                        "(also per-token int8 activations, int8 x int8 "
                        "GEMMs); auto picks w8a8 for ViT-B and larger")
    parser.add_argument("--calibrate", default=None, metavar="IMAGES.BIN",
                        help="calibration images for outlier-aware W8A8: "
                        "calibrated per-channel absmax, hot channels kept in "
                        "bf16 (implies w8a8 when --quantize is auto or "
                        "unset)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the gpu backend; cpu runs every "
                        "kernel's plain PyTorch version")
    parser.add_argument("--no-round-weights", action="store_true",
                        help="skip the reference's 6-decimal weight rounding")
    parser.add_argument("--print-labels", action="store_true",
                        help="also print human-readable class names")
    parser.add_argument("--pure-python", action="store_true",
                        help="force the NumPy io layer instead of libvitio")
    args = parser.parse_args(argv)

    cfg = config_lib.get_config(args.config)

    nio = None
    if not args.pure_python:
        from .runtime import get_native_io

        nio = get_native_io()

    t0 = time.perf_counter()
    if args.raw_images:
        from .io import preprocess

        images = preprocess.preprocess_files(
            args.raw_images, img_size=cfg.img_size,
            resize_size=round(cfg.img_size * 256 / 224),
        )
    elif nio is not None:
        images = nio.load_images(args.input)
    else:
        images = binfmt.load_image_data(args.input)
    if nio is not None:
        weights = nio.load_weights(
            args.weights, len(binfmt.weight_names(cfg)),
            round_to_6dp=not args.no_round_weights, strict=True,
        )
    else:
        weights = binfmt.load_weights(
            args.weights, cfg, round_to_6dp=not args.no_round_weights, strict=True
        )
    params = binfmt.weights_to_dict(weights, cfg)
    t_load = time.perf_counter() - t0
    print(f"loaded {images.shape[0]} images + {len(weights)} weights "
          f"in {t_load:.2f}s ({'libvitio' if nio else 'numpy'} io)")

    calibrate = None
    if args.calibrate:
        if args.backend != "gpu":
            raise SystemExit("--calibrate only applies to the gpu backend")
        if args.quantize in (None, "auto"):
            args.quantize = "int8-w8a8"
        calibrate = (nio.load_images(args.calibrate) if nio is not None
                     else binfmt.load_image_data(args.calibrate))
        print(f"calibration set: {calibrate.shape[0]} images "
              f"({args.calibrate})")

    print("=====================Start========================")
    t0 = time.perf_counter()
    probs = _run_backend(args.backend, images, params, cfg, args.batch_size,
                         args.attention, args.device, args.quantize, calibrate)
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

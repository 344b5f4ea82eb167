"""Probe for the port's calibrated W8A8 fixture: how far each mode moves from
fp32 on adversarial ViT-B/16 weights, at a few classifier-head scales.

``chip_smoke.py`` phase 3c scales the adversarial fixture's head so that
quantization errors show in the probabilities, and gates the calibrated
W8A8 main path on the reference comparator (0.01). This probe measures, per
head scale, on 40 decisive images (fp32 top-2 logits at least 0.05 apart,
from a seeded pool of 96) and 16 seeded calibration images: the mean fp32
top probability, and the max abs probability error and top-1 flips against
the port's fp32 plain path (TF32 off) of calibrated W8A8 through the
kernels and through the chain's plain versions, plain W8A8, and unquantized
bf16. A scale where even bf16 misses the gate cannot test the kernels.

Run on a machine with an NVIDIA card, from the repository root:

    python scripts/probe_torch_head_scale.py
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vit_with_opencl_tpu_torch import VIT_B_16_224 as CFG  # noqa: E402
from vit_with_opencl_tpu_torch.engine import InferenceEngine  # noqa: E402
from vit_with_opencl_tpu_torch.harness import fixtures  # noqa: E402
from vit_with_opencl_tpu_torch.models import vit  # noqa: E402
from vit_with_opencl_tpu_torch.ops import fused_block  # noqa: E402

HEAD_SCALES = (6.0, 3.0, 1.5)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    base = fixtures.adversarial_params(CFG, seed=0)
    pool = fixtures.random_images(CFG, n=96, seed=1)
    calib = fixtures.random_images(CFG, n=16, seed=99)
    for scale in HEAD_SCALES:
        named = dict(base)
        named["heads_head_weight"] = base["heads_head_weight"] * scale
        stacked = vit.stack_params(named, CFG, param_dtype=torch.float32, device=dev)
        with torch.inference_mode():
            logits = torch.cat([
                vit.forward(torch.from_numpy(pool[i:i + 16]).to(dev), stacked, CFG,
                            compute_dtype=torch.float32, return_logits=True)
                for i in range(0, len(pool), 16)])
        del stacked
        top2 = logits.topk(2, dim=-1).values
        keep = np.flatnonzero((top2[:, 0] - top2[:, 1]).cpu().numpy() >= 0.05)[:40]
        images = pool[keep]
        ref = torch.softmax(logits[keep], dim=-1).cpu().numpy()
        line = [f"scale {scale}: {len(keep)} images, mean fp32 top prob "
                f"{ref.max(-1).mean():.3f}"]

        def report(name, probs):
            line.append(f"{name} err {np.abs(probs - ref).max():.4f} flips "
                        f"{int((probs.argmax(-1) != ref.argmax(-1)).sum())}")
            return probs

        for name, kw in (("calibrated", dict(quantize="int8-w8a8", calibrate=calib)),
                         ("plain w8a8", dict(quantize="int8-w8a8")), ("bf16", {})):
            t0 = time.perf_counter()
            engine = InferenceEngine(CFG, named, batch_size=16, attention_impl="flash",
                                     device=dev, **kw)
            line.append(f"({name} set-up {time.perf_counter() - t0:.1f} s)")
            probs = report(name, engine.run(images))
            if name == "calibrated":
                kernel_version = fused_block.fused_encoder_layer
                fused_block.fused_encoder_layer = fused_block.fused_encoder_layer_reference
                try:
                    plain = report("calibrated plain chain", engine.run(images))
                finally:
                    fused_block.fused_encoder_layer = kernel_version
                line.append(f"kernels vs plain chain {np.abs(plain - probs).max():.2e}")
            del engine
        print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

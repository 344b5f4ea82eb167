"""Batched inference engine on one device.

Counterpart of ``vit_with_opencl_tpu/engine.py:InferenceEngine``: the
weights go to the device once at construction, the forward runs at one
static batch size and the last batch is padded (excess rows discarded), and
every batch is enqueued before the results are gathered in one copy back to
the host. PyTorch runs eagerly, so there is no compile step; ``warmup``
builds the CUDA kernels (at first use) and runs one batch.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import ViTConfig
from .models import vit

# ImageNet normalisation for raw uint8 pixels: x_norm = (x - mean) * inv_std
# (the JAX package's io/preprocess.py IMAGENET_MEAN, IMAGENET_STD and
# uint8_normalize_constants).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Raises when a CUDA device is asked for and there is none: the
    port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


class InferenceEngine:
    """Batched ViT inference on one device.

    Args:
      config: model architecture.
      named_params: {name: shaped numpy array} from ``io.binfmt.weights_to_dict``.
      batch_size: the static batch of every forward; inputs are padded to a
        multiple of it.
      param_dtype / compute_dtype: bf16 by default, fp32 for parity testing.
      attention_impl: 'xla' (plain PyTorch) or 'flash' (the CUDA kernels).
      device: 'cuda' (default) or 'cpu'.
      quantize: must be None; int8 and W8A8 are not ported yet.
      normalize_uint8: take raw uint8 pixels and normalise them on the device.
    """

    def __init__(
        self,
        config: ViTConfig,
        named_params: Dict[str, np.ndarray],
        *,
        batch_size: int = 32,
        param_dtype: torch.dtype = torch.bfloat16,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "xla",
        device: Optional[torch.device | str] = None,
        quantize: Optional[str] = None,
        normalize_uint8: bool = False,
    ):
        if quantize is not None:
            raise NotImplementedError(
                f"quantize={quantize!r}: int8 and W8A8 inference are not "
                "ported yet (ROADMAP.md, Queue 2: _block_kernel quantized "
                "with models/quant.py)")
        self.config = config
        self.batch_size = int(batch_size)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.normalize_uint8 = normalize_uint8
        t0 = time.perf_counter()
        self.params = vit.stack_params(named_params, config,
                                       param_dtype=param_dtype,
                                       device=self.device)
        self.kernels = vit.resolve_kernels(attention_impl)
        self._mean = torch.from_numpy(
            IMAGENET_MEAN.reshape(1, 3, 1, 1) * 255.0).to(self.device)
        self._inv_std = torch.from_numpy(
            1.0 / (IMAGENET_STD.reshape(1, 3, 1, 1) * 255.0)).to(self.device)
        self.setup_time = time.perf_counter() - t0

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """One batch already on the device → probabilities [B, classes]."""
        if self.normalize_uint8:
            images = (images.float() - self._mean) * self._inv_std
        return vit.forward(images, self.params, self.config,
                           compute_dtype=self.compute_dtype,
                           kernels=self.kernels)

    def warmup(self) -> float:
        """Run one zero batch (building the kernels at first use); returns
        its wall time in seconds."""
        t0 = time.perf_counter()
        c, s = self.config.in_chans, self.config.img_size
        dtype = torch.uint8 if self.normalize_uint8 else torch.float32
        out = self.forward(torch.zeros((self.batch_size, c, s, s), dtype=dtype,
                                       device=self.device))
        out.cpu()
        return time.perf_counter() - t0

    def run(self, images: np.ndarray) -> np.ndarray:
        """All-images inference → probabilities [n, num_classes] (fp32 numpy)."""
        images = np.asarray(images)
        in_dtype = np.uint8 if self.normalize_uint8 else np.float32
        if self.normalize_uint8 and images.dtype != np.uint8:
            raise ValueError(
                f"engine was built with normalize_uint8=True and expects raw "
                f"uint8 pixels, got {images.dtype}")
        if not self.normalize_uint8 and images.dtype == np.uint8:
            raise ValueError(
                "got raw uint8 pixels but the engine expects normalized "
                "float32 inputs; preprocess first or build the engine with "
                "normalize_uint8=True")
        images = np.asarray(images, in_dtype)
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.config.num_classes), np.float32)
        bs = self.batch_size
        outputs = []
        for start in range(0, n, bs):
            chunk = images[start:start + bs]
            if chunk.shape[0] < bs:
                pad = np.zeros((bs - chunk.shape[0],) + chunk.shape[1:], in_dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            outputs.append(self.forward(torch.from_numpy(chunk).to(self.device)))
        # One copy back to the host, after every batch was enqueued.
        return torch.cat(outputs).cpu().numpy()[:n]

"""Batched inference engines: one device, and data-parallel over several.

Counterpart of ``vit_with_opencl_tpu/engine.py:InferenceEngine``: the
weights go to the device once at construction, the forward runs at one
static batch size and the last batch is padded (excess rows discarded), and
every batch is enqueued before the results are gathered in one copy back to
the host. PyTorch runs eagerly, so there is no compile step; ``warmup``
builds the CUDA kernels (at first use) and runs one batch.
``DataParallelEngine`` (JAX's of the same name) splits each batch over the
devices of a mesh, with the weights replicated.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import ViTConfig
from .debug import checked_forward
from .models import quant, vit
from .ops import fused_block

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


def resolve_quantize(quantize: Optional[str], config: ViTConfig,
                     *, calibrated: bool = False) -> Optional[str]:
    """Resolve the ``"auto"`` quantize mode to a concrete one, by the JAX
    package's rule: ``int8-w8a8`` unless the config's bf16 encoder runs as
    the whole stack (``fused_block.supports_stack``, the small configs,
    which W8A8 would send back to the per-layer chain), where ``auto`` stays
    unquantized. ``calibrated`` (the caller gave calibration images) picks
    ``int8-w8a8`` for every config. ViT-B/16 resolves to ``int8-w8a8``."""
    if quantize != "auto":
        return quantize
    if calibrated:
        return "int8-w8a8"
    if fused_block.supports_stack(config, dtype_bytes=2):
        return None
    return "int8-w8a8"


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
      quantize: None, 'int8' (weight-only: int8 weights, per-channel scale
        epilogue), 'int8-w8a8' (also per-token int8 activations into the
        encoder's GEMMs; the int8 weights stored K-major,
        ``quant.w8a8_layout``) or 'auto' (``resolve_quantize``). The weights
        are stacked to ``param_dtype`` first and quantized from that.
      normalize_uint8: take raw uint8 pixels and normalise them on the device.
      calibrate: calibration images (normalised fp32 [n, C, H, W]) for the
        outlier-aware W8A8 mode: with ``int8-w8a8`` (or ``auto``, which then
        picks it) the weights go through ``quant.calibrate_w8a8`` instead of
        plain quantization.
      check_numerics: every forward counts its non-finite outputs on the
        device and raises ``FloatingPointError`` if there are any
        (``debug.checked_forward``; one scalar read back a batch).
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
        calibrate: Optional[np.ndarray] = None,
        check_numerics: bool = False,
    ):
        quantize = resolve_quantize(quantize, config,
                                    calibrated=calibrate is not None)
        if quantize not in (None, "int8", "int8-w8a8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if calibrate is not None and quantize is None:
            raise ValueError(
                "calibrate= images are only meaningful with "
                "quantize='int8-w8a8' (outlier-aware activation quantization)")
        self.config = config
        self.quantize = quantize
        self.batch_size = int(batch_size)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.normalize_uint8 = normalize_uint8
        t0 = time.perf_counter()
        params = vit.stack_params(named_params, config,
                                  param_dtype=param_dtype, device=self.device)
        if calibrate is not None and quantize == "int8-w8a8":
            # Outlier-aware W8A8: calibrate per-channel activation absmax on
            # the images (on the device), permute the hot channels into
            # groups that stay bf16 and quantize the rest (on the host), as
            # the JAX engine does; then the weights go back to the device.
            params = vit.params_to(quant.calibrate_w8a8(
                np.asarray(calibrate, np.float32), params, config), self.device)
        elif quantize is not None:
            params = quant.quantize_stacked_params(params, config)
        if quantize == "int8-w8a8":
            # The W8A8 GEMM reads its int8 weights K-major: one copy on the
            # device now, none in a forward.
            params = quant.w8a8_layout(params)
        self.params = params
        self.kernels = vit.resolve_kernels(
            attention_impl, w8a8=quantize == "int8-w8a8",
            heads=(config.num_heads, config.head_dim))
        self._mean = torch.from_numpy(
            IMAGENET_MEAN.reshape(1, 3, 1, 1) * 255.0).to(self.device)
        self._inv_std = torch.from_numpy(
            1.0 / (IMAGENET_STD.reshape(1, 3, 1, 1) * 255.0)).to(self.device)
        if check_numerics:
            # NaN guard (the reference's findNaN, ViT_opencl.c:1050-1061, as
            # an always-on option instead of commented-out call sites).
            self.forward = checked_forward(self.forward,
                                           what=f"{config.name} forward")
        self.setup_time = time.perf_counter() - t0

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """One batch already on the device → probabilities [B, classes]."""
        return vit.forward(self._preprocess(images), self.params, self.config,
                           compute_dtype=self.compute_dtype,
                           kernels=self.kernels)

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """Raw uint8 pixels normalised on their device (with
        ``normalize_uint8``); otherwise ``images`` as given."""
        if not self.normalize_uint8:
            return images
        dev = images.device
        return (images.float() - self._mean.to(dev)) * self._inv_std.to(dev)

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


class DataParallelEngine(InferenceEngine):
    """Batched inference data-parallel over a device mesh.

    The same ``run``/``warmup``/``forward``/``batch_size`` surface as
    ``InferenceEngine``: the batch is split over ``devices`` (a mesh of
    (n, 1), as ``parallel.spmd.dp_forward_fn`` splits it), the weights
    replicated on each (stacked, quantized or calibrated once, as the
    single-device engine does), no communication but the results' copy to
    the first device. ``batch_size`` is global and must divide by the device
    count. ``devices`` defaults to every CUDA device (it raises without
    one); ``["cpu"] * 8`` runs the plain versions on the CPU. A device may
    repeat: ``["cuda:0"] * 4`` is a virtual mesh of one card.
    ``tuning_path`` (the autotune cache) is not ported and raises."""

    def __init__(
        self,
        config: ViTConfig,
        named_params: Dict[str, np.ndarray],
        *,
        batch_size: int = 32,
        devices=None,
        param_dtype: torch.dtype = torch.bfloat16,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "flash",
        quantize: Optional[str] = None,
        normalize_uint8: bool = False,
        tuning_path: Optional[str] = None,
        calibrate: Optional[np.ndarray] = None,
    ):
        from .parallel import mesh as mesh_mod, spmd

        if tuning_path is not None:
            raise NotImplementedError(
                "the autotune cache (tuning_path) is not ported yet")
        devices = list(devices) if devices is not None else mesh_mod.default_devices()
        self.n_devices = len(devices)
        if int(batch_size) % self.n_devices:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{self.n_devices} devices")
        t0 = time.perf_counter()
        self.mesh = mesh_mod.make_mesh(data=self.n_devices, model=1,
                                       devices=devices)
        super().__init__(config, named_params, batch_size=batch_size,
                         param_dtype=param_dtype, compute_dtype=compute_dtype,
                         attention_impl=attention_impl,
                         device=self.mesh.devices[0, 0],
                         quantize=quantize, normalize_uint8=normalize_uint8,
                         calibrate=calibrate)
        self._replicas = spmd.replicate_params(self.params, self.mesh)
        self._dp_forward = spmd.dp_forward_fn(
            config, self.mesh, compute_dtype=compute_dtype,
            kernels=self.kernels, preprocess=self._preprocess)
        self.setup_time = time.perf_counter() - t0

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """One global batch (on any device) → probabilities [B, classes] on
        the first device: each device's slice through the forward there
        (``parallel.spmd.dp_forward_fn``)."""
        return self._dp_forward(images, self._replicas)

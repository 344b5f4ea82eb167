"""Synthetic fixture generation (weights + inputs) for tests and benchmarks.

The reference ships no fixture-generation code — its ``.bin`` files were
exported offline from torchvision (the weight filenames are torchvision
state-dict keys). 36 of the 152 weight files are also stripped from the
mounted copy. This module fills both gaps: deterministic synthetic weights in
the exact on-disk format, so every layer of the stack (loader, golden model,
engine, comparator) can be exercised hermetically. A copy of the JAX
package's ``harness/fixtures`` (the same seeds give the same arrays).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import ViTConfig
from ..io import binfmt


def random_params(
    config: ViTConfig, seed: int = 0, scale: float = 0.02
) -> Dict[str, np.ndarray]:
    """Deterministic random weights, {name: shaped float32 array}.

    LayerNorm scales are drawn near 1 and biases near 0 so activations stay
    in a realistic range through 12+ pre-LN blocks.
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in binfmt.weight_shapes(config).items():
        if name.endswith(("ln_weight", "ln_1_weight", "ln_2_weight")):
            arr = 1.0 + scale * rng.standard_normal(shape)
        else:
            arr = scale * rng.standard_normal(shape)
        out[name] = arr.astype(np.float32)
    return out


def params_to_positional(
    params: Dict[str, np.ndarray], config: ViTConfig
) -> List[np.ndarray]:
    """{name: array} → positional list in Weight_<idx> order."""
    return [params[name] for name in binfmt.weight_names(config)]


def random_images(
    config: ViTConfig, n: int = 1, seed: int = 1
) -> np.ndarray:
    """Synthetic normalized image batch [n, c, h, w] float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, config.in_chans, config.img_size, config.img_size)
    ).astype(np.float32)


def adversarial_params(
    config: ViTConfig,
    seed: int = 0,
    scale: float = 0.02,
    outlier_channels: int = 8,
    ln_gain: float = 30.0,
    v_gain: float = 12.0,
    fc1_gain: float = 12.0,
) -> Dict[str, np.ndarray]:
    """Weights that mimic trained-ViT activation statistics: the regime that
    breaks per-token absmax W8A8 quantization.

    Trained transformers carry a few persistent channels whose activations
    run 10-100x hotter than the rest, amplified by LayerNorm gains (the
    SmoothQuant paper, arXiv:2211.10438). Gaussian weights (``random_params``)
    have none, so a W8A8 parity number measured on them says nothing about
    real checkpoints. This fixture injects the mechanism on the same channel
    identities at every layer:

      * ``ln_gain`` lognormal-jittered spikes on ``outlier_channels`` of the
        ln_1/ln_2 gains: outlier channels at the qkv and fc1 GEMM inputs;
      * ``v_gain`` on the V rows of in_proj: outlier channels in the
        attention context (the out-proj GEMM input);
      * ``fc1_gain`` on fc1 output rows: hot GELU outputs into fc2.
    """
    params = random_params(config, seed=seed, scale=scale)
    rng = np.random.default_rng(seed + 7919)
    d, h = config.embed_dim, config.hidden_dim
    k = min(outlier_channels, d, h)
    ch_d = rng.choice(d, k, replace=False)
    ch_h = rng.choice(h, k, replace=False)
    for layer in range(config.depth):
        pfx = f"encoder_layers_encoder_layer_{layer}_"
        for ln_key in ("ln_1_weight", "ln_2_weight"):
            g = ln_gain * np.exp(0.25 * rng.standard_normal(k))
            params[pfx + ln_key][ch_d] *= g.astype(np.float32)
        # torch [out, in] layouts: V block rows 2D..3D of in_proj, fc1 out rows
        params[pfx + "self_attention_in_proj_weight"][2 * d + ch_d, :] *= v_gain
        params[pfx + "mlp_0_weight"][ch_h, :] *= fc1_gain
    return params

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

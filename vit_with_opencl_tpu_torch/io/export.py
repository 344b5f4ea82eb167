"""Checkpoint export to the reference format (``Weight_<idx>_<name>.bin``).

Counterpart of ``export_weights`` and ``_validate`` in
``vit_with_opencl_tpu/io/export.py``: a dict of named fp32 arrays (the
reference's torchvision-style names, as ``models/vit.unstack_params``
gives them) written as the reference's directory of per-tensor raw-fp32
files, which the port's CLI and engine load. The torchvision and
HuggingFace converters of that module are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..config import ViTConfig
from . import binfmt


def _validate(params: Dict[str, np.ndarray], config: ViTConfig) -> None:
    shapes = binfmt.weight_shapes(config)
    for name, expected in shapes.items():
        if name not in params:
            raise KeyError(f"exporter produced no tensor for {name!r}")
        got = params[name].shape
        if tuple(got) != tuple(expected):
            raise ValueError(f"{name}: shape {got} != expected {expected}")


def export_weights(params: Dict[str, np.ndarray], directory: str | os.PathLike,
                   config: ViTConfig) -> List[str]:
    """Write {name: array} to ``Weight_<idx>_<name>.bin`` files; returns the
    file names written."""
    names = binfmt.weight_names(config)
    binfmt.save_weights(directory, [params[n] for n in names], config)
    return [f"Weight_{i}_{n}.bin" for i, n in enumerate(names)]

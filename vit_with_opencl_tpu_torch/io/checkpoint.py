"""Framework-native checkpoints on ``torch.save`` beside the reference format.

Counterpart of ``vit_with_opencl_tpu/io/checkpoint.py`` (Orbax there): a
checkpoint is one file, ``state.pt`` inside the checkpoint's directory,
holding a nested tree of dicts and tuples with tensor, NumPy and scalar
leaves (params, optimizer state, the step, an EMA shadow). Tensors are
saved from the host, so a checkpoint loads on any device.

``checkpoint_structure`` reads what a checkpoint holds without a template,
so a caller can adapt (``train.Trainer.resume`` across EMA on/off and an
optimizer-state change); ``load_checkpoint`` with ``like`` (or
``restore_like`` on a loaded tree) restores onto the template's devices and
checks that the structure, shapes and dtypes match it, raising
``ValueError`` where they do not, as an Orbax restore is strict.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_FILE = "state.pt"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def save_checkpoint(path: str | os.PathLike, tree: Dict[str, Any]) -> None:
    """Save a tree (nested dicts and tuples of tensors, arrays and scalars)
    under the directory ``path``; written to a temporary file and renamed,
    so a reader sees the whole checkpoint or none."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}.tmp")
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def _read(path) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location="cpu", weights_only=False)


def _describe(tree):
    if isinstance(tree, dict):
        return {k: _describe(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_describe(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        a = np.asarray(tree)
        return (a.shape, a.dtype)
    return tree


def checkpoint_structure(path: str | os.PathLike) -> Optional[Dict[str, Any]]:
    """What the checkpoint holds: its tree with each array leaf replaced by
    ``(shape, dtype)``; None if the file cannot be read."""
    try:
        tree = _read(path)
    except Exception:  # noqa: BLE001 — unreadable or foreign: no structure
        return None
    return _describe(tree) if isinstance(tree, dict) else None


def restore_like(saved, like, where: str = "checkpoint"):
    """``saved`` (a tree as loaded) checked against the template ``like``
    and moved to its devices; ``ValueError`` where structure, shape or dtype
    differ."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"{where}: the checkpoint holds "
                             f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__}, "
                             f"the template {sorted(like)}")
        return {k: restore_like(saved[k], like[k], f"{where}/{k}") for k in like}
    if isinstance(like, (tuple, list)):
        if not isinstance(saved, (tuple, list)) or len(saved) != len(like):
            raise ValueError(f"{where}: the checkpoint's structure differs "
                             "from the template's")
        return type(like)(restore_like(s, l, f"{where}[{i}]")
                          for i, (s, l) in enumerate(zip(saved, like)))
    if isinstance(like, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != like.shape
                or saved.dtype != like.dtype):
            got = ((tuple(saved.shape), saved.dtype)
                   if isinstance(saved, torch.Tensor) else type(saved).__name__)
            raise ValueError(f"{where}: the checkpoint holds {got}, the "
                             f"template {(tuple(like.shape), like.dtype)}")
        return saved.to(like.device)
    return saved


def load_checkpoint(path: str | os.PathLike,
                    like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load a checkpoint. With ``like`` (a tree of the same structure), the
    tensors go to the template's devices and any difference of structure,
    shape or dtype raises ``ValueError``; without it, the tree as saved,
    on the host."""
    tree = _read(path)
    return tree if like is None else restore_like(tree, like)

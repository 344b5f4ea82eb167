"""Numerics debugging helpers.

Counterpart of ``vit_with_opencl_tpu/debug.py``. The reference carries a
host-side NaN scanner, ``findNaN(buf, tokens, dims)`` (reference:
ViT_opencl.c:1050-1061), with call sites commented out through the encoder
(:720,726,734,961). These are the working equivalents:

  * ``find_nan``: scan a tensor, or a dict, list or tuple nesting tensors
    (a parameter tree), for non-finite values, reporting which leaf and how
    many;
  * ``checked_forward``: wrap a forward fn so every call asserts finite
    outputs (the count taken on the outputs' device, one scalar read back);
  * for tracing the *origin* of a NaN, ``torch.autograd.detect_anomaly()``
    names the backward op that made it; in a forward, ``find_nan`` on the
    intermediates.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf in JAX's order (a dict's keys sorted),
    paths in JAX's ``keystr`` form (``['layers']['qkv_w']``, ``[0]``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _is_float(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def find_nan(tree: Any, name: str = "tree") -> List[Tuple[str, int, int]]:
    """Scan a tree of tensors (or arrays) for non-finite values.

    Returns [(leaf_path, nan_count, inf_count)] for offending leaves only
    (empty list = clean). Reads each leaf's counts back to the host — a
    debugging tool, not a hot-path check (use ``checked_forward`` for
    that)."""
    out = []
    for path, leaf in _leaves(tree):
        if not _is_float(leaf):
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        nan = int(torch.isnan(t).sum())
        inf = int(torch.isinf(t).sum())
        if nan or inf:
            out.append((name + path, nan, inf))
    return out


def checked_forward(fn: Callable, what: str = "forward") -> Callable:
    """Wrap a forward fn with a finiteness check on its outputs.

    The count of non-finite values is taken on the outputs' device (one
    scalar), read back per call; raises FloatingPointError with the count
    on failure — the always-on production equivalent of the reference's
    commented-out findNaN call sites."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = 0
        for _path, leaf in _leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                bad = bad + (leaf.numel() - torch.isfinite(leaf).sum())
        bad_count = int(bad)
        if bad_count:
            raise FloatingPointError(
                f"{what}: {bad_count} non-finite output values")
        return out

    return wrapped

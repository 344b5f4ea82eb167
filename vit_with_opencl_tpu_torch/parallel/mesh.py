"""A device mesh driven by one process: the port's ``jax.sharding.Mesh``.

Counterpart of ``vit_with_opencl_tpu/parallel/spmd.make_mesh``. JAX's
``Mesh`` with ``shard_map`` is one Python program driving every device; so
is this: a grid of ``torch.device``s with named axes, over which the SPMD
bodies of ``parallel/spmd.py`` and ``ops/ring_attention.py`` run as loops
over the shards, exchanging tensors through ``parallel/collectives.py``.
The same code runs on several cards (``cuda:0..3``: the copies between
them are peer copies, and each kernel launches with its tensors' card
current, ``ops/_build.launch``) and on a virtual mesh that repeats one
device (``["cpu"] * 8``, as the JAX tests' 8 virtual CPU devices, or
``["cuda:0"] * 4``, which gives ring attention a real 4-step ring on one
card). A mesh of processes (``torch.distributed``) is the counterpart of
``parallel/multihost.py``, which is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A grid of devices with one name per axis. ``shape`` maps each axis
    name to its size, in order, as JAX's ``Mesh.shape`` does; ``devices``
    is the grid (a NumPy array of ``torch.device``). A device may appear
    more than once."""

    def __init__(self, devices: Any, axis_names: Sequence[str] = ("data", "model")):
        grid = np.asarray(devices, dtype=object)
        flat = [canonical_device(d) for d in grid.ravel()]
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, dev in zip(np.ndindex(grid.shape), flat):
            self.devices[idx] = dev
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device grid")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name``, at position 0 on every other
        axis."""
        at = tuple(slice(None) if name == axis_name else 0
                   for name in self.axis_names)
        return list(self.devices[at])


def canonical_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device`` with its index: "cuda" names the
    current card, so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_devices() -> list:
    """Every CUDA device. Raises without one: there is no CPU fallback; a
    caller that wants the CPU passes its devices, e.g. ``["cpu"] * 8``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices= (for example "
            "['cpu'] * 8) to run the plain PyTorch versions on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = 1, model: int = 1, *,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ("data", "model") mesh over the first ``data * model`` of
    ``devices`` (default: every CUDA device), row-major, so that a data row
    holds ``model`` consecutive devices."""
    devs = [canonical_device(d) for d in (devices if devices is not None
                                          else default_devices())]
    need = data * model
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devs[:need]):
        grid[i // model, i % model] = dev
    return Mesh(grid, axis_names=("data", "model"))

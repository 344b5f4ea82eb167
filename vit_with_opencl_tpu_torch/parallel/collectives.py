"""The collectives of the SPMD bodies, over the shards of one mesh axis.

A body that JAX writes for one shard under ``shard_map`` is written here
as a loop over the shards of an axis, each shard a tensor on its own
device; these functions stand for JAX's collectives on such a list:

| JAX primitive  | here                                                    |
|----------------|---------------------------------------------------------|
| ``all_gather`` | ``torch.cat`` of the shards, each copied to the device   |
| ``ppermute``   | the shard list rotated, each moved with ``.to(dst)``     |
| ``psum``       | a sum in shard order 0..n-1, then placed on each device  |
| ``psum_scatter`` | the same sum, chunked along ``dim``                    |

``.to()`` to the device a tensor is already on returns that tensor, and
shards on one device share one result: the results are read-only, and no
caller writes into a tensor that a collective gave it.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _per_device(fn, devices: Sequence[torch.device]) -> list:
    """``fn(device)`` once per distinct device, in shard order."""
    cache = {}
    out = []
    for dev in devices:
        if dev not in cache:
            cache[dev] = fn(dev)
        out.append(cache[dev])
    return out


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int) -> list:
    """Every shard's view of the shards concatenated along ``dim`` (JAX's
    ``all_gather(..., axis=dim, tiled=True)``)."""
    return _per_device(lambda dev: torch.cat([x.to(dev) for x in xs], dim),
                       devices)


def ppermute(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> list:
    """Shard i's tensor sent to shard i + 1 (mod n): JAX's ``ppermute``
    with the ring permutation [(i, (i + 1) % n)]."""
    n = len(xs)
    return [xs[(j - 1) % n].to(devices[j]) for j in range(n)]


def _total(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def psum(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> list:
    """The sum of the shards, taken in shard order on the first shard's
    device, on every shard's device."""
    total = _total(xs, devices[0])
    return _per_device(lambda dev: total.to(dev), devices)


def psum_scatter(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
                 dim: int) -> list:
    """Shard j's chunk of the sum along ``dim`` (JAX's ``psum_scatter(...,
    scatter_dimension=dim, tiled=True)``); ``dim`` must divide by the
    shard count."""
    n = len(xs)
    total = _total(xs, devices[0])
    if total.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {total.shape[dim]} does "
                         f"not divide into {n} shards")
    return [chunk.to(dev) for chunk, dev in zip(total.chunk(n, dim), devices)]

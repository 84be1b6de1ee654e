"""One-process ``shard_map`` and its collectives over a ``launch.mesh.
Mesh`` (the port's counterpart of ``repro/compat.py`` ``shard_map`` with
``jax.lax.all_gather`` / ``psum`` inside the body).

The reference runs a body once per device of a mesh axis under
``shard_map``. Here one process does the same in shard order:

* ``shard_map(body, mesh=..., in_specs=..., axis=...)(*operands)`` splits
  each operand along the dimension its spec names ``axis`` at (a
  ``sharding.P``; ``P()`` replicates) into per-shard tensors on
  ``mesh.axis_devices(axis)[s]``, runs ``body`` once per shard, and
  returns the list of per-shard results. A shard on the operand's own
  device is a view of it, never a copy.
* ``all_gather(parts, dim)`` concatenates per-shard tensors on the first
  shard's device: data movement only, so per-shard values keep their
  bits.
* ``psum(parts)`` sums them on the first shard's device, in shard order:
  the one collective that does arithmetic.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.distributed.sharding import P


def _split(x, spec, axis: str, devices) -> list:
    n = len(devices)
    if x is None:
        return [None] * n
    dims = [i for i, e in enumerate(spec) if e == axis]
    if not dims:
        return [x.to(d) for d in devices]
    dim = dims[0]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over mesh axis '{axis}' ({n})")
    return [t.to(d) for t, d in zip(torch.tensor_split(x, n, dim), devices)]


def shard_map(body: Callable, *, mesh, in_specs: Sequence[P], axis: str):
    """``body`` run once per shard of ``mesh`` along ``axis``; the
    returned callable takes the operands and gives the per-shard
    results, in shard order."""
    devices = mesh.axis_devices(axis)

    def run(*operands) -> List:
        if len(operands) != len(in_specs):
            raise ValueError(f"{len(operands)} operands, {len(in_specs)} "
                             "specs")
        parts = [_split(x, spec, axis, devices)
                 for x, spec in zip(operands, in_specs)]
        return [body(*(p[s] for p in parts)) for s in range(len(devices))]
    return run


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate per-shard tensors along ``dim`` on the first shard's
    device (``jax.lax.all_gather(..., tiled=True)``)."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors on the first shard's device, in shard
    order (``jax.lax.psum``)."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total

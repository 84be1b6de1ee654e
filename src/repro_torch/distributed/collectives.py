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
* ``psum(parts)`` sums them on the first shard's device, in shard order.
* ``reduce_scatter(parts, dim)`` is ``psum`` in shard order, after which
  shard s keeps its s-th block along ``dim``, on its own device
  (``jax.lax.psum_scatter(..., tiled=True)``). A part may be a list of
  tensors (a flattened tree), with one ``dim`` per tensor; a ``dim`` of
  None keeps the whole sum (an all-reduce). ``parts`` may be a generator:
  the sum is kept as it goes, so at most one part is held besides it.

``BYTES`` counts, per collective kind (``all-gather``, ``all-reduce``,
``reduce-scatter``), the bytes each call's output holds on one device,
the convention of the reference's HLO count (``repro/launch/roofline.py``
``analyze_hlo``: a collective's output shape). ``reset_bytes()`` sets the
counts to 0, as a kernel's ``launches`` is reset.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence

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


BYTES = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}


def reset_bytes():
    for k in BYTES:
        BYTES[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate per-shard tensors along ``dim`` on the first shard's
    device (``jax.lax.all_gather(..., tiled=True)``)."""
    dev = parts[0].device
    out = torch.cat([p.to(dev) for p in parts], dim=dim)
    BYTES["all-gather"] += _nbytes(out)
    return out


def psum(parts: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors on the first shard's device, in shard
    order (``jax.lax.psum``)."""
    it = iter(parts)
    total = next(it)
    for p in it:
        total = total + p.to(total.device)
    BYTES["all-reduce"] += _nbytes(total)
    return total


def reduce_scatter(parts: Iterable, dim) -> list:
    """``psum`` of the parts in shard order, then shard s keeps block s
    along ``dim`` (a copy of its own, on the device of part s). Each part
    is a tensor, or a list of tensors with ``dim`` a list of the same
    length (None: the shard keeps the whole sum). Returns, per shard, its
    block (or list of blocks). The first part's tensors become the sum:
    the caller hands over parts it no longer needs."""
    single = isinstance(dim, int) or dim is None
    dims = [dim] if single else list(dim)
    total, devices = None, []
    for part in parts:
        part = [part] if single else list(part)
        devices.append(part[0].device)
        if total is None:
            total = part
        else:
            for t, p in zip(total, part):
                t.add_(p.to(t.device))
        del part
    n = len(devices)
    out = [[] for _ in range(n)]
    for t, d in zip(total, dims):
        if d is None:
            BYTES["all-reduce"] += _nbytes(t)
            for s, dev in enumerate(devices):
                out[s].append(t if dev == t.device else t.to(dev))
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not "
                             f"split over {n} shards")
        blocks = t.tensor_split(n, d)
        BYTES["reduce-scatter"] += _nbytes(blocks[0])
        for s, dev in enumerate(devices):
            out[s].append(blocks[s].to(dev).clone(
                memory_format=torch.contiguous_format))
    return [o[0] for o in out] if single else out

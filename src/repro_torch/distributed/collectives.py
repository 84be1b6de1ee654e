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
* ``psum(parts)`` sums them on the first shard's device, in shard order,
  in the parts' dtype: a bf16 model's partial products are added in
  bf16. The sharded bf16 steps so summed are held against the
  reference's GSPMD-jitted ones by the bf16 rule
  (``tests/test_torch_bf16_steps.py``).
* ``reduce_scatter(parts, dim)`` is ``psum`` in shard order, after which
  shard s keeps its s-th block along ``dim``, on its own device
  (``jax.lax.psum_scatter(..., tiled=True)``). A part may be a list of
  tensors (a flattened tree), with one ``dim`` per tensor; a ``dim`` of
  None keeps the whole sum (an all-reduce). ``parts`` may be a generator:
  the sum is kept as it goes, so at most one part is held besides it.

Four differentiable collectives over the "model" axis carry the
tensor-parallel (Megatron) layers of the train step, each an
``autograd.Function`` whose backward is the collective's transpose:

* ``copy_to_model(x, n)`` hands ``x`` to each of ``n`` model shards; its
  backward is the ``psum`` of the shards' grads (an all-reduce);
* ``reduce_from_model(parts)`` is the ``psum`` of the shards' partial
  results; its backward hands each part the incoming grad;
* ``gather_over_model(blocks, dim)`` is ``all_gather``; its backward
  gives each block its slice of the grad and moves nothing, since every
  shard computes the whole grad of the gathered tensor.
* ``sum_over_model(parts)`` is the ``psum`` of partial results that
  every shard then uses on its own (a statistic over channels split
  across the shards); its backward is the ``psum`` of the shards' grads
  of the sum, so it counts an all-reduce in each direction.

Over one shard each is the identity and counts nothing. Under remat the
recomputed forward runs its collectives again, and they count again.

``BYTES`` counts, per collective kind (``all-gather``, ``all-reduce``,
``reduce-scatter``), the bytes each call's output holds on one device,
the convention of the reference's HLO count (``repro/launch/roofline.py``
``analyze_hlo``: a collective's output shape). ``GATHERS`` counts the
serving steps' gathers the same way, each under a kind of its own:
``read`` puts a region of a cache leaf laid out on a mesh
(``sharding.Tiles``) together for attention ("kv over model", "kv over
data"), ``gather_logits`` the vocab-split logits ("logits over model").
``reset_bytes()`` sets both to 0, as a kernel's ``launches`` is reset.
One process runs the collectives of every group of devices;
``counting(False)`` leaves out the calls made for the groups that do
not hold mesh position 0, so that the counts stay one device's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import P, Tiles, _inter, _rel


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
# the serving steps' gathers, each under a kind of its own (all-gathers
# in the HLO's terms, kept out of ``BYTES``): cache blocks put together
# for attention across the model shards or the data shards (``read``),
# and the vocab-split last-position logits (``gather_logits``)
GATHERS = {"kv over model": 0, "kv over data": 0, "logits over model": 0}
# a module global, not thread-local: autograd runs a CUDA backward on a
# worker thread of its own
_COUNTING = [True]


def reset_bytes():
    for d in (BYTES, GATHERS):
        for k in d:
            d[k] = 0


@contextlib.contextmanager
def counting(on: bool):
    """Count the collectives called inside (``on``) or not."""
    prev, _COUNTING[0] = _COUNTING[0], bool(on)
    try:
        yield
    finally:
        _COUNTING[0] = prev


def is_counting() -> bool:
    return _COUNTING[0]


def _count(kind: str, nbytes: int):
    if _COUNTING[0]:
        BYTES[kind] += nbytes


def _count_gather(kind: str, nbytes: int):
    if _COUNTING[0]:
        GATHERS[kind] = GATHERS.get(kind, 0) + nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate per-shard tensors along ``dim`` on the first shard's
    device (``jax.lax.all_gather(..., tiled=True)``)."""
    dev = parts[0].device
    out = torch.cat([p.to(dev) for p in parts], dim=dim)
    _count("all-gather", _nbytes(out))
    return out


def psum(parts: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors on the first shard's device, in shard
    order (``jax.lax.psum``)."""
    it = iter(parts)
    total = next(it)
    for p in it:
        total = total + p.to(total.device)
    _count("all-reduce", _nbytes(total))
    return total


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise maximum of per-shard tensors on the first shard's
    device (``jax.lax.pmax``), an all-reduce."""
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p.to(total.device))
    _count("all-reduce", _nbytes(total))
    return total


def reduce_scatter(parts: Iterable, dim, counted=None) -> list:
    """``psum`` of the parts in shard order, then shard s keeps block s
    along ``dim`` (a copy of its own, on the device of part s). Each part
    is a tensor, or a list of tensors with ``dim`` a list of the same
    length (None: the shard keeps the whole sum). Returns, per shard, its
    block (or list of blocks). The first part's tensors become the sum:
    the caller hands over parts it no longer needs. ``counted``, a list
    of bools like ``dim``, leaves the tensors marked False uncounted (the
    same collective of another group of devices)."""
    single = isinstance(dim, int) or dim is None
    dims = [dim] if single else list(dim)
    counted = [True] * len(dims) if counted is None else list(counted)
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
    for t, d, c in zip(total, dims, counted):
        if d is None:
            if c:
                _count("all-reduce", _nbytes(t))
            for s, dev in enumerate(devices):
                out[s].append(t if dev == t.device else t.to(dev))
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not "
                             f"split over {n} shards")
        blocks = t.tensor_split(n, d)
        if c:
            _count("reduce-scatter", _nbytes(blocks[0]))
        for s, dev in enumerate(devices):
            out[s].append(blocks[s].to(dev).clone(
                memory_format=torch.contiguous_format))
    return [o[0] for o in out] if single else out


# ---------------------------------------------------------------------------
# Differentiable collectives over the model axis (Megatron's f and g)
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return psum(grads), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        return psum(parts)

    @staticmethod
    def backward(ctx, g):
        return tuple(g.to(d) for d in ctx.devices)


class _GatherOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *blocks):
        ctx.dim = dim
        ctx.sizes = [b.shape[dim] for b in blocks]
        ctx.devices = [b.device for b in blocks]
        return all_gather(blocks, dim)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(
            p.to(d) for p, d in zip(g.split(ctx.sizes, ctx.dim),
                                    ctx.devices))


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        total = psum(parts)
        return tuple(total.to(d).view_as(total) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        g = psum(grads)
        return tuple(g.to(d) for d in ctx.devices)


def copy_to_model(x: torch.Tensor, n: int) -> list:
    """``x`` handed to each of ``n`` model shards; backward: the psum of
    their grads (a counted all-reduce)."""
    return [x] if n == 1 else list(_CopyToModel.apply(x, n))


def reduce_from_model(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The psum of the model shards' partial results (a counted
    all-reduce); backward: each part gets the incoming grad."""
    return parts[0] if len(parts) == 1 else _ReduceFromModel.apply(*parts)


def gather_over_model(blocks: Sequence[torch.Tensor], dim: int) \
        -> torch.Tensor:
    """The model shards' blocks concatenated along ``dim`` (a counted
    all-gather); backward: each block its slice of the grad."""
    return blocks[0] if len(blocks) == 1 else \
        _GatherOverModel.apply(dim, *blocks)


def sum_over_model(parts: Sequence[torch.Tensor]) -> list:
    """The psum of the model shards' partial results, handed back to
    every shard (a counted all-reduce); backward: the psum of the
    shards' grads (a counted all-reduce), handed to each part."""
    return list(parts) if len(parts) == 1 else \
        list(_SumOverModel.apply(*parts))


# ---------------------------------------------------------------------------
# The serving steps' gathers
# ---------------------------------------------------------------------------
def read(leaf, region, what: str = "kv", prefer: int = 0) -> torch.Tensor:
    """The logical tensor of ``region`` ((start, stop) per dimension) of a
    cache leaf: a tensor's slice, or from a ``sharding.Tiles`` the tile
    that holds all of it (a view; the tile itself where the region is the
    tile's, model index ``prefer`` first among replicas), else the region
    put together from the tiles that hold its parts, on the first one's
    device. A region put together across model indices counts as an
    all-gather over "model" under ``"<what> over model"``, across data
    indices as one over the data axes under ``"<what> over data"``;
    across both, as one over "model" within a data index (the bytes of
    the first data index's part) and then one over the data axes."""
    if not isinstance(leaf, Tiles):
        return leaf[tuple(slice(a, b) for a, b in region)]
    region = tuple(region)
    held = [tl for tl in leaf.tiles
            if all(r[0] <= w[0] and w[1] <= r[1]
                   for r, w in zip(tl[0], region))]
    if held:
        reg, t, _m, _d = min(held, key=lambda tl: tl[2] != prefer)
        if reg == region:
            return t
        return t[_rel(region, reg)]
    parts = {}
    for tl in sorted(leaf.tiles, key=lambda tl: tl[2] != prefer):
        cut = tuple(_inter(r, w) for r, w in zip(tl[0], region))
        if all(c is not None for c in cut):
            parts.setdefault(cut, tl)
    first = next(iter(parts.values()))[1]
    out = torch.empty(tuple(b - a for a, b in region), dtype=first.dtype,
                      device=first.device)
    for cut, (reg, t, _m, _d) in parts.items():
        out[_rel(cut, region)] = t[_rel(cut, reg)].to(out.device)
    models = {tl[2] for tl in parts.values()}
    datas = {tl[3] for tl in parts.values()}
    el = out.element_size()
    if len(models) > 1:
        d0 = next(iter(parts.values()))[3]
        n = sum(int(np.prod([b - a for a, b in cut]))
                for cut, tl in parts.items() if tl[3] == d0) \
            if len(datas) > 1 else out.numel()
        _count_gather(f"{what} over model", n * el)
    if len(datas) > 1:
        _count_gather(f"{what} over data", out.numel() * el)
    return out


def gather_logits(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The model shards' vocab blocks of the logits concatenated along the
    last dimension (an all-gather over "model", counted under ``"logits
    over model"``)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    out = torch.cat([p.to(dev) for p in parts], dim=-1)
    _count_gather("logits over model", _nbytes(out))
    return out

"""Logical-axis sharding rules -> PartitionSpec resolution
(``repro/distributed/sharding.py``, its framework-free logic).

Model code names tensor axes logically ("batch", "heads", "mlp", ...);
launch code installs a rules table mapping logical names to mesh axis
names, and ``logical_spec(...)`` resolves a tuple of names to a
``PartitionSpec`` under it. ``P`` stands in for JAX's ``PartitionSpec``:
a tuple of mesh axis names (a name, a tuple of names, or None per
dimension, trailing Nones dropped) with the ``P.UNCONSTRAINED`` sentinel.
The serving backend reads these specs through the one-process
``distributed.collectives.shard_map``.

``shd`` checks the rank of its tensor against the names and returns it:
the reference turns it into a GSPMD sharding constraint, which a
one-process port has no counterpart of (and which the reference itself
skips when no rules are installed).

The rules' other consumers place whole tensors: ``NamedSharding(mesh,
spec)`` is the reference's record of a layout, ``shard(x, sharding)``
cuts a logical tensor into a ``ShardedTensor`` (one tensor per mesh
position, as a sharded ``jax.Array`` holds one buffer per device),
``unshard`` puts it back together (``shard_tree`` / ``unshard_tree`` for
trees), and ``shard_bytes`` is what one device holds. The sharded train
step (``training/steps.py`` with ``grad_specs``), the sharded serving
steps (``shardings=``), ``checkpoint.restore(shardings=...)`` and the
dry-run (``launch/dryrun.py``) use them. ``Tiles`` is a cache leaf's
blocks as a serving step's layers see them; ``tiles_put`` and
``tiles_scatter`` write into them.

``tp_plan`` reads the rules for the tensor-parallel train step: per
param leaf split over "model", whether its layer works on the blocks
Megatron-style (``"split"``: attention heads, the SwiGLU's hidden width,
experts, the vocabulary, and the recurrent blocks' ``rnn`` channels and
``ssm_heads``, as the reference's rules and activation constraints
partition them) or all-gathers them first and runs replicated
(``"gather"``: q / kv weights cut on the head dim, and leaves not
named). A data shard's layers then see such a leaf as ``Blocks``, its
model shards' blocks in shard order.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

_STATE = threading.local()


class _Unconstrained:
    def __repr__(self):
        return "UNCONSTRAINED"


class P(tuple):
    """A PartitionSpec: one entry per tensor dimension."""
    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def current_rules() -> Mapping[str, object] | None:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, object] | None):
    """Install logical->mesh axis rules. Values: mesh axis name, tuple of
    mesh axis names, or None (replicated)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = dict(rules) if rules is not None else None
    try:
        yield
    finally:
        _STATE.rules = prev


_MISSING = object()


def _resolve_one(name: str | None, rules: Mapping[str, object]):
    """Returns mesh axes, None (explicit: hard-replicate), or _MISSING
    (unknown name: leave unconstrained in activation contexts)."""
    if name is None:
        return _MISSING
    return rules.get(name, _MISSING)


def logical_spec(axes: Sequence[str | None],
                 unconstrained_unnamed: bool = False) -> P:
    """Resolve logical axis names to a PartitionSpec under current rules.

    Each mesh axis appears at most once (first occurrence wins); later
    conflicting dims are replicated. With ``unconstrained_unnamed``
    (activation constraints), unnamed/unmapped dims become
    ``P.UNCONSTRAINED`` instead of replicated."""
    rules = current_rules()
    if rules is None:
        return P()
    unnamed = P.UNCONSTRAINED if unconstrained_unnamed else None
    used: set[str] = set()
    out = []
    for name in axes:
        r = _resolve_one(name, rules)
        if r is _MISSING:
            out.append(unnamed)
            continue
        if r is None:               # explicit None: hard replication
            out.append(None)
            continue
        parts = (r,) if isinstance(r, str) else tuple(r)
        free = tuple(p for p in parts if p not in used)
        if len(free) != len(parts):  # conflict -> leave unconstrained
            out.append(unnamed)
            continue
        used.update(free)
        out.append(free[0] if len(free) == 1 else free)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def shd(x, *axes: str | None):
    """The reference's sharding constraint: checks ``x``'s rank against
    ``axes`` when rules are installed and returns ``x`` (no GSPMD in one
    process)."""
    if current_rules() is not None and x.dim() != len(axes):
        raise ValueError(f"rank {x.dim()} != {len(axes)} logical axes "
                         f"{axes}")
    return x


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and not isinstance(v, P) and \
        all(isinstance(e, (str, type(None))) for e in v)


def spec_tree(axes_tree):
    """Map a tree (dicts, lists) of logical-axes tuples to a tree of
    PartitionSpecs."""
    if _is_axes(axes_tree):
        return logical_spec(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: spec_tree(v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(spec_tree(v) for v in axes_tree)
    return axes_tree


def zero1_spec(spec: P, shape: Sequence[int], data_axes: Iterable[str],
               data_size: int) -> P:
    """ZeRO-1: additionally shard the first divisible, unsharded dim of an
    optimizer-state tensor over the data axes. Falls back to ``spec``."""
    data_axes = tuple(data_axes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is None:
            continue
        for a in (e,) if isinstance(e, str) else e:
            used.add(a)
    if any(a in used for a in data_axes):
        return spec
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % data_size == 0 and dim > 0:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            while entries and entries[-1] is None:
                entries.pop()
            return P(*entries)
    return spec


# Default rules for the production meshes. "model" carries TP/EP; batch is
# data-parallel over (pod, data). Head counts that don't divide the model
# axis fall back to sharding the head_dim instead.
def make_rules(mesh, cfg=None, *, seq_shard: bool = False,
               batch_shard: bool = True) -> dict:
    axes = mesh.axis_names
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    msz = mesh.shape.get("model", 1)

    def pick(n_units, unit_dim):
        """(axis for the unit dim, axis for the per-unit dim)."""
        if n_units % msz == 0:
            return "model", None
        if unit_dim % msz == 0:
            return None, "model"
        return None, None

    kvh_ax, kvd_ax = None, "model"
    if cfg is not None:
        heads_ax, qdim_ax = pick(cfg.num_heads, cfg.head_dim_)
        kvh_ax, kvd_ax = pick(cfg.num_kv_heads, cfg.head_dim_)
    else:
        heads_ax, qdim_ax = "model", None

    rules = {
        "batch": (data_axes if len(data_axes) > 1 else data_axes[0])
        if batch_shard else None,
        "heads": heads_ax,
        "q_head_dim": qdim_ax,
        "kv_heads": kvh_ax,
        "kv_head_dim": kvd_ax,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "rnn": "model",
        "ssm_heads": "model",
        # activation-only rules: attention never contracts a model-sharded
        # head_dim; Q/K/V are head-sharded or hard-replicated on "model"
        "attn_q": heads_ax,            # None => hard replicate
        "attn_kv": kvh_ax,
        "attn_dim": None,              # hard: never shard activation D
    }
    if seq_shard:
        rules["seq"] = "model"          # Megatron-style sequence parallelism
    return rules


def serving_rules(mesh, cfg, axis: str = "heads") -> dict:
    """Rules for the 1-D tensor-parallel serving mesh (``launch.mesh.
    make_serving_mesh`` and the ``sharded`` attention backend): q/kv heads
    over the single mesh axis, which must divide both head counts."""
    n = mesh.shape.get(axis, 1)
    if cfg.num_heads % n or cfg.num_kv_heads % n:
        raise ValueError(
            f"{cfg.name}: head counts ({cfg.num_heads}/{cfg.num_kv_heads}) "
            f"must divide the serving mesh axis '{axis}' ({n})")
    return {"heads": axis, "kv_heads": axis,
            "q_head_dim": None, "kv_head_dim": None}


def serving_kv_shards(mesh, cfg, axis: str = "heads") -> int:
    """KVPool shard count matching the serving mesh's head split."""
    n = mesh.shape.get(axis, 1)
    serving_rules(mesh, cfg, axis)      # validates divisibility
    return n


def kv_cache_spec(mesh, cfg, batch_shard: bool = True,
                  seq_axis: str | None = None) -> dict:
    """Mesh axes of the decode/prefill cache leaves k/v [G?, B, S, Hkv,
    D]: batch over data axes, kv-heads or head_dim over model
    (divisibility-aware), optionally sequence over ``seq_axis``."""
    daxes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    b_ax = (daxes if len(daxes) > 1 else daxes[0]) if batch_shard else None
    msz = mesh.shape.get("model", 1)
    if cfg.num_kv_heads % msz == 0:
        h_ax, d_ax = "model", None
    elif cfg.head_dim_ % msz == 0:
        h_ax, d_ax = None, "model"
    else:
        h_ax = d_ax = None
    return {"b": b_ax, "s": seq_axis, "h": h_ax, "d": d_ax}


# ---------------------------------------------------------------------------
# Whole tensors laid out on a mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NamedSharding:
    """A layout: ``spec`` (a ``P``) over ``mesh`` (``launch.mesh.Mesh``),
    as the reference's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P


def _dim_axes(spec: P, ndim: int) -> list:
    """The mesh axes each of ``ndim`` dimensions is split over (a tuple,
    empty where the dimension is replicated)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        if e is None or e is P.UNCONSTRAINED:
            out.append(())
        else:
            out.append((e,) if isinstance(e, str) else tuple(e))
    return out


def data_dim(spec: P, data_axes: Iterable[str]):
    """The dimension ``spec`` splits over any of ``data_axes``, or None."""
    data_axes = tuple(data_axes)
    for i, axes in enumerate(_dim_axes(spec, len(spec))):
        if any(a in data_axes for a in axes):
            return i
    return None


def shard_slices(shape: Sequence[int], sharding: NamedSharding,
                 index: Sequence[int]) -> tuple:
    """The slice of a tensor of ``shape`` held at mesh position ``index``.
    A dimension split over axes (a, b) is cut into size(a) x size(b)
    blocks, block a_i x size(b) + b_i at (a_i, b_i), the axes taken in
    the spec's order (the rules list them in mesh-axis order), as GSPMD
    cuts it; blocks are ceil(dim / blocks) long, so the last ones may be
    short or empty, where GSPMD pads."""
    mesh = sharding.mesh
    names = mesh.axis_names
    out = []
    for size, axes in zip(shape, _dim_axes(sharding.spec, len(shape))):
        k, n = 0, 1
        for a in axes:
            k = k * mesh.shape[a] + index[names.index(a)]
            n *= mesh.shape[a]
        c = -(-size // n)
        out.append(slice(min(k * c, size), min((k + 1) * c, size)))
    return tuple(out)


def shard_bytes(shape: Sequence[int], dtype: torch.dtype,
                sharding: NamedSharding) -> int:
    """Bytes one device holds of a tensor of ``shape`` and ``dtype`` laid
    out by ``sharding``: every split dimension rounded up to a whole
    block, as GSPMD pads an uneven shard."""
    n = 1
    for size, axes in zip(shape, _dim_axes(sharding.spec, len(shape))):
        parts = math.prod(sharding.mesh.shape[a] for a in axes)
        n *= -(-size // parts)
    return n * torch.empty((), dtype=dtype, device="meta").element_size()


class ShardedTensor:
    """A logical tensor of ``shape`` and ``dtype`` laid out by
    ``sharding``: ``shards`` is a numpy object array shaped like the mesh,
    one tensor per position on that position's device. Positions that
    hold the same slice on the same device share one tensor (a
    replicated leaf on a mesh whose shards share a card is one tensor,
    not copies)."""

    def __init__(self, shards: np.ndarray, sharding: NamedSharding,
                 shape: Sequence[int], dtype: torch.dtype):
        self.shards = shards
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return (f"ShardedTensor({self.shape}, {self.dtype}, "
                f"{self.sharding.spec} over {self.sharding.mesh.shape})")


# ---------------------------------------------------------------------------
# The tensor-parallel execution plan
# ---------------------------------------------------------------------------
# the leaves a layer splits Megatron-style, by name, and the dimension of
# the per-layer tensor the split cuts: attention by q / kv heads, the
# SwiGLU by its hidden width (column then row), the MoE by experts, the
# vocabulary of both embeddings, the RG-LRU block by its rnn channels
# (``wx`` / ``wy`` columns, ``wo_r`` rows) and the SSD block by its heads
# and their channels (``in_proj`` stays whole, as in the reference); the
# depthwise ``conv`` cuts its channels in both recurrent kinds
MEGATRON_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "wi": 2, "wo_ff": 0,
                 "wi_e": 0, "wo_e": 0, "embed": 0, "unembed": 1,
                 "wx": 1, "wy": 1, "conv": 1, "lam": 0, "alpha": 0,
                 "beta": 0, "wo_r": 0, "A_log": 0, "D": 0, "dt_bias": 0,
                 "out_norm": 0, "out_proj": 0}


@dataclass(frozen=True)
class TPLeaf:
    """A param leaf's route in ``tp_plan``: ``"split"`` or ``"gather"``
    over the model axis, on dimension ``dim`` of the per-layer tensor
    (a stacked ``groups`` leaf has one more, leading)."""
    route: str
    dim: int


@dataclass
class Blocks:
    """A leaf split over the model axis as a data shard's layers see it:
    the model shards' blocks in shard order, the dimension of the
    per-layer tensor they cut, and the plan's route."""
    parts: list
    dim: int
    route: str

    def unbind(self) -> list:
        """A stacked ``[G, ...]`` leaf's blocks, one ``Blocks`` a layer."""
        return [Blocks(list(ts), self.dim, self.route)
                for ts in zip(*(p.unbind(0) for p in self.parts))]


def tp_plan(mesh, cfg, axes_tree):
    """The tensor-parallel route of every param leaf: a tree like
    ``axes_tree`` (``models.model.param_axes(cfg)``) holding None where
    ``make_rules(mesh, cfg)`` leaves the leaf whole on every model shard,
    else a ``TPLeaf``. A leaf goes ``"split"`` where the rules cut it on
    its Megatron dimension (``MEGATRON_DIMS``: q heads when ``heads``
    resolves to "model", kv heads when ``kv_heads`` does, the SwiGLU's
    ``mlp``, ``experts``, ``vocab``, the recurrent blocks' ``rnn`` and
    ``ssm_heads``), and ``"gather"`` otherwise: q / kv weights cut on the
    head dim (heads that do not divide) and any leaf not named. The kv
    weights are not split unless the q weights are."""
    msz = mesh.shape.get("model", 1)
    with axis_rules(make_rules(mesh, cfg)):
        specs = spec_tree(axes_tree)

    def leaf(name, axes, spec, lead):
        if msz == 1:
            return None
        for i, ax in enumerate(_dim_axes(spec, len(axes))):
            if "model" in ax:
                dim = i - lead
                return TPLeaf("split" if MEGATRON_DIMS.get(name) == dim
                              else "gather", dim)
        return None

    def layer(axes, spec, lead):
        out = {n: leaf(n, axes[n], spec[n], lead) for n in axes}
        if "wq" in out and getattr(out["wq"], "route", None) != "split":
            for n in ("wk", "wv", "wo"):
                if out[n] is not None:
                    out[n] = TPLeaf("gather", out[n].dim)
        return out
    top = {n: leaf(n, axes_tree[n], specs[n], 0)
           for n in ("embed", "unembed", "final_norm")}
    # a stack of no whole group holds empty group dicts (init_params)
    top["groups"] = [layer(a, s, 1) if cfg.n_groups else {}
                     for a, s in zip(axes_tree["groups"], specs["groups"])]
    top["tail"] = [layer(a, s, 0) for a, s in zip(axes_tree["tail"],
                                                  specs["tail"])]
    return top


def _full(sl, shape) -> bool:
    return all(s.start == 0 and s.stop == n for s, n in zip(sl, shape))


def shard(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Lay ``x`` out by ``sharding`` (``jax.device_put(x, sharding)``).
    A position whose slice is the whole of ``x`` on ``x``'s own device
    holds ``x`` itself; a split slice is a contiguous copy of its own, so
    that ``x`` can be freed; a slice is copied once per device however
    many positions hold it there."""
    devices = sharding.mesh.devices
    shards = np.empty(devices.shape, dtype=object)
    placed = {}
    for idx in np.ndindex(devices.shape):
        sl = shard_slices(x.shape, sharding, idx)
        dev = torch.device(devices[idx])
        key = (tuple((s.start, s.stop) for s in sl), str(dev))
        if key not in placed:
            if _full(sl, x.shape) and x.device == dev:
                placed[key] = x
            elif x.device == dev:
                placed[key] = x[sl].clone(
                    memory_format=torch.contiguous_format)
            else:
                placed[key] = x[sl].to(dev,
                                       memory_format=torch.contiguous_format)
        shards[idx] = placed[key]
    return ShardedTensor(shards, sharding, x.shape, x.dtype)


def unshard(st: ShardedTensor) -> torch.Tensor:
    """The logical tensor back, on the first position's device (the one
    shard itself when every position holds all of it)."""
    first = st.shards.flat[0]
    mesh = st.sharding.mesh
    if all(_full(shard_slices(st.shape, st.sharding, idx), st.shape)
           for idx in np.ndindex(mesh.devices.shape)):
        return first
    out = torch.empty(st.shape, dtype=st.dtype, device=first.device)
    done = set()
    for idx in np.ndindex(mesh.devices.shape):
        sl = shard_slices(st.shape, st.sharding, idx)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            out[sl] = st.shards[idx].to(first.device)
            done.add(key)
    return out


def _map_tree(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_tree(fn, t, *r)
                          for t, *r in zip(tree, *rest))
    return fn(tree, *rest)


def shard_tree(tree, shardings):
    """A tree (dicts, lists) of tensors laid out leaf by leaf by the
    matching tree of ``NamedSharding`` (``jax.device_put(tree,
    shardings)``): a tree of ``ShardedTensor``."""
    return _map_tree(lambda x, s: shard(x, s), tree, shardings)


def unshard_tree(tree):
    """``shard_tree``'s inverse: each ``ShardedTensor`` put back together
    (``unshard``)."""
    return _map_tree(unshard, tree)


# ---------------------------------------------------------------------------
# A cache leaf of one data shard's rows, as the serving step's layers see it
# ---------------------------------------------------------------------------
class Tiles:
    """The blocks of one cache leaf that hold a data shard's rows (all
    rows, where the batch is not split), as a serving step's layers read
    and write them. ``shape`` is the rows' logical leaf; each tile is
    (``region``, the tensor of that region, its model index, its data
    index), ``region`` a (start, stop) per dimension in the rows'
    coordinates. Positions that hold one tensor give one tile; replicas
    on other devices are tiles of their own, and every write reaches each.
    ``distributed.collectives.read`` puts a region back together."""

    def __init__(self, shape, tiles):
        self.shape = tuple(shape)
        self.tiles = list(tiles)

    def __getitem__(self, g: int) -> "Tiles":
        """Layer ``g`` of a group-stacked leaf (its lead axis is never
        split)."""
        return Tiles(self.shape[1:], [(r[1:], t[g], m, d)
                                      for r, t, m, d in self.tiles])

    @classmethod
    def of(cls, st: ShardedTensor, batch_dim: int, data_index=None):
        """The tiles of ``st`` at the mesh positions of data index
        ``data_index`` (a tuple over the data axes; None: every position,
        all rows), their batch dimension ``batch_dim`` cut to the rows of
        that data shard."""
        mesh = st.sharding.mesh
        names = mesh.axis_names
        dax = [i for i, a in enumerate(names) if a in ("pod", "data")]
        mi = names.index("model") if "model" in names else None
        shape = list(st.shape)
        r0 = 0
        tiles, seen = [], set()
        for idx in np.ndindex(mesh.devices.shape):
            didx = tuple(idx[i] for i in dax)
            if data_index is not None and didx != tuple(data_index):
                continue
            sl = shard_slices(st.shape, st.sharding, idx)
            if data_index is not None:
                b = sl[batch_dim]
                r0 = b.start
                shape[batch_dim] = b.stop - b.start
            t = st.shards[idx]
            if id(t) in seen:
                continue
            seen.add(id(t))
            region = tuple((s.start, s.stop) for s in sl)
            tiles.append((region, t, 0 if mi is None else idx[mi],
                          int(np.ravel_multi_index(
                              didx, [mesh.devices.shape[i] for i in dax]))
                          if dax else 0))
        if data_index is not None:
            tiles = [(tuple((a - r0, b - r0) if i == batch_dim else (a, b)
                            for i, (a, b) in enumerate(reg)), t, m, d)
                     for reg, t, m, d in tiles]
        return cls(shape, tiles)


def full_region(shape, fixed=None) -> tuple:
    """The (start, stop) of every dimension of ``shape``, those of the
    dimensions ``fixed`` names ({dim: (start, stop)}) as given."""
    fixed = fixed or {}
    return tuple(fixed.get(i, (0, n)) for i, n in enumerate(shape))


def _inter(a, b):
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _rel(region, origin):
    return tuple(slice(a - o[0], b - o[0]) for (a, b), o in
                 zip(region, origin))


def tiles_put(leaf, region, value):
    """Write ``value`` (the logical tensor of ``region``) into ``leaf``: a
    tensor's slice, or every tile of a ``Tiles`` its part."""
    if not isinstance(leaf, Tiles):
        leaf[tuple(slice(a, b) for a, b in region)].copy_(value)
        return
    for reg, t, _m, _d in leaf.tiles:
        cut = [_inter(r, w) for r, w in zip(reg, region)]
        if any(c is None for c in cut):
            continue
        t[_rel(cut, reg)].copy_(value[_rel(cut, region)].to(t.device))


def tiles_scatter(leaf, bi, slot, value, tail=()):
    """``leaf[bi, slot, *tail] = value``: rows ``bi`` and slots ``slot``
    (1-d index tensors) of the first two dimensions, ``value`` [n, ...]
    covering the region ``tail`` of the others (the whole of them where
    ``tail`` is shorter). Into a ``Tiles``, each tile takes the entries
    whose row and slot it holds, on the part of ``tail`` it holds."""
    if not isinstance(leaf, Tiles):
        leaf[(bi, slot) + tuple(slice(a, b) for a, b in tail)] = value
        return
    rest = leaf.shape[2:]
    tail = tuple(tail) + tuple((0, n) for n in rest[len(tail):])
    for reg, t, _m, _d in leaf.tiles:
        cut = [_inter(r, w) for r, w in zip(reg[2:], tail)]
        if any(c is None for c in cut):
            continue
        (b0, b1), (s0, s1) = reg[:2]
        lead = (0, leaf.shape[0]), (0, leaf.shape[1])
        if (b0, b1) == lead[0] and (s0, s1) == lead[1]:
            rb, rs, v = bi, slot, value
        else:
            sel = (bi >= b0) & (bi < b1) & (slot >= s0) & (slot < s1)
            rb, rs, v = bi[sel] - b0, slot[sel] - s0, value[sel]
        src = (slice(None),) + _rel(cut, tail)
        t[(rb.to(t.device), rs.to(t.device)) + _rel(cut, reg[2:])] = \
            v[src].to(t.device)

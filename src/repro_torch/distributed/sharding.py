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
skips when no rules are installed). The GSPMD consumers of the rules
(sharded training, the dry-run) are not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Mapping, Sequence

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

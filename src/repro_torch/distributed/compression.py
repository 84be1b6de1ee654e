"""Gradient compression: the int8 error-feedback all-reduce
(``repro/distributed/compression.py``).

Gradients are quantized to int8 with one fp32 scale per tensor before the
cross-replica sum (a quarter of the fp32 bytes on the wire), and each
replica keeps its quantization error and adds it to the next step's
gradient (error feedback), so the error is carried forward instead of
lost. The reference runs inside ``shard_map`` with a mesh axis name; here
the replicas are explicit: ``compressed_psum`` and ``ef_allreduce_grads``
take one value (or tree of tensors: dicts and lists) per shard of a mesh
axis, in shard order, and sum with ``collectives.psum``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.distributed.collectives import psum


def quantize_int8(x: torch.Tensor):
    """(q int8, scale fp32 scalar): scale = max|x| / 127 + 1e-12, q =
    clip(round(x / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(xs: Sequence[torch.Tensor]) \
        -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """int8-quantized mean of one tensor per shard: (the mean, on each
    shard's device; each shard's local error x - deq(q(x)), which callers
    add into their error-feedback buffer)."""
    deqs, errs = [], []
    for x in xs:
        q, scale = quantize_int8(x)
        deq = dequantize_int8(q, scale)
        deqs.append(deq)
        errs.append(x - deq)
    mean = psum(deqs) / float(len(xs))
    return [mean.to(x.device) for x in xs], errs


def _flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """Leaves of a tree of dicts and lists, in key / index order, and the
    function that rebuilds a tree of that structure from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        subs = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        subs = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(s[0]) for s in subs]
    leaves = [x for s in subs for x in s[0]]

    def rebuild(new):
        out, i = [], 0
        for (_, fn), n in zip(subs, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return leaves, rebuild


def ef_allreduce_grads(grads: Sequence[Any], ef: Sequence[Any]):
    """Error-feedback compressed gradient mean over the shards (one grads
    tree and one error tree per shard): per leaf, x = g + e,
    g' = mean(deq(q(x))), e' = x - deq(q(x)). Returns (one mean tree per
    shard, one error tree per shard)."""
    if len(grads) != len(ef):
        raise ValueError(f"{len(grads)} grads trees, {len(ef)} error trees")
    flat = [_flatten(g) for g in grads]
    flat_e = [_flatten(e)[0] for e in ef]
    n_leaves = len(flat[0][0])
    means = [[None] * n_leaves for _ in grads]
    errs = [[None] * n_leaves for _ in grads]
    for i in range(n_leaves):
        xs = [f[0][i].float() + e[i] for f, e in zip(flat, flat_e)]
        m, er = compressed_psum(xs)
        for s in range(len(grads)):
            means[s][i], errs[s][i] = m[s], er[s]
    rebuild = flat[0][1]
    return [rebuild(m) for m in means], [rebuild(e) for e in errs]


def init_error_feedback(params: Any) -> Any:
    """Zero fp32 error buffers shaped like ``params``."""
    leaves, rebuild = _flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves])


def compression_ratio(params: Any) -> float:
    """Bytes over the wire vs an fp32 all-reduce (scales amortize away)."""
    return 1.0 / 4.0

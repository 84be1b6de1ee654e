"""AdamW and its learning-rate schedule, as plain functions on tensors
(``repro/training/optimizer.py``; no ``torch.optim``).

The optimizer state is ``{"m": tree, "v": tree, "count": int32}`` with
``m`` / ``v`` fp32 trees shaped like the params. ``adamw_update`` is the
reference's function of ``(grads, opt_state, params)``, step for step in
the same fp32 order; it writes the new params, ``m`` and ``v`` into the
given tensors under ``torch.no_grad()`` (a full-width model's state is
tens of GB, so it is not copied) and returns them. The global norm sums
the leaves in the reference's leaf order (``jax.tree.leaves``: dict keys
sorted, lists in order), so both packages reduce in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator

import torch


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> Iterator[Any]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists and
    tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def tree_map(fn, tree):
    """``fn`` over the leaves, keeping the dict / list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over the leaves of ``tree``, taking the
    same dict key or list index in ``other`` (whose leaves may be tuples,
    such as PartitionSpecs)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; fp32 on the
    device of ``step`` (an integer tensor, or an int for the CPU)."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * scale


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = next(tree_leaves(params))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_scalars(cfg: AdamWConfig, count, gnorm):
    """The step's scalars from the count before it and the global grad
    norm: (new count, lr, clip scale, bias corrections 1 and 2)."""
    lr = cosine_lr(cfg, count)
    count = count + 1
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    return count, lr, scale, 1 - cfg.b1 ** count, 1 - cfg.b2 ** count


@torch.no_grad()
def adamw_leaf(cfg: AdamWConfig, g, m, v, p, scale, lr, bc1, bc2):
    """One leaf's update, in place on ``m``, ``v`` and ``p``: elementwise,
    so a slice of a leaf updates to the same bits as the whole."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    del g
    step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    step += cfg.weight_decay * p32
    p.copy_(p32 - lr * step)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns ``(params, opt_state, metrics)``, the params and moments
    updated in place. Master math in fp32; params keep their storage
    dtype. The lr is read at the count before this update. ``grads`` is a
    tree like ``params``."""
    gnorm = global_norm(grads)
    count, lr, scale, bc1, bc2 = adamw_scalars(cfg, opt_state["count"],
                                               gnorm)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        adamw_leaf(cfg, g, m, v, p, scale, lr, bc1, bc2)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, {"lr": lr, "grad_norm": gnorm}

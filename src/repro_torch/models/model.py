"""Decoder stack of the dense attention family (``pattern=("attn",)``),
in PyTorch, with the reference's four execution modes:

  mode="prefill"  full forward, returns per-layer KV cache (+ the
                  Cache-Craft attention statistics when requested)
  mode="partial"  Cache-Craft partial prefill: hidden states exist ONLY
                  for the active tokens (new chunks + recompute +
                  question); cached KV occupies its slots, fresh KV is
                  scattered in, and Q attends across the merged KV with a
                  position mask
  mode="decode"   single-token step against the cache (arena or pool twin)
  mode="train"    full causal forward without a cache

Parameters are a plain dict of tensors in the reference's layout:
``groups`` is a list (one entry per pattern position) of dicts whose
leaves are stacked ``[G, ...]`` along the reference's scan axis, and
``tail`` a list of per-layer dicts; ``params_from_jax`` turns the
reference pytree (as numpy arrays) into this layout, so both packages
compute the same function in the tests.

Caches carry an explicit per-slot position array, so causality always
derives from absolute positions. The reference donates caches to its
jitted steps; here the cache tensors are updated IN PLACE (``index_put_``
into views of the stacked leaves) and the returned cache shares storage
with the one passed in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import backend as AB
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[str(name)]


def _check_kind(kind: str):
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet "
            "(ROADMAP A8); the port runs the dense attention family")


# ---------------------------------------------------------------------------
# Parameter definitions: one source of truth for init and shapes
# ---------------------------------------------------------------------------
def _layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    _check_kind(kind)
    d, h, hkv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE FFN is not ported to repro_torch yet (ROADMAP A8)")
    return {
        "ln1": ((d,), "zero"),
        "wq": ((d, h, dh), "fan_in"),
        "wk": ((d, hkv, dh), "fan_in"),
        "wv": ((d, hkv, dh), "fan_in"),
        "wo": ((h, dh, d), "fan_in2"),
        "ln2": ((d,), "zero"),
        "wi": ((d, 2, f), "fan_in"),
        "wo_ff": ((f, d), "fan_in"),
    }


def _init_leaf(gen, shape, init, dtype, device, lead=()):
    """``lead`` prepends stacking axes (the reference's scan axis) without
    changing the fan-in of the layer's own shape."""
    full = tuple(lead) + tuple(shape)
    if init == "zero":
        return torch.zeros(full, dtype=dtype, device=device)
    fan_in = shape[0] if init == "fan_in" else int(np.prod(shape[:2]))
    out = torch.randn(full, generator=gen, dtype=torch.float32,
                      device=device)
    out.mul_(1.0 / np.sqrt(max(1, fan_in)))
    return out if dtype == torch.float32 else out.to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random init on ``generator``'s device (a CUDA generator creates
    the weights directly on the card; the full-width model would take
    minutes to create on the host). Same distributions as the reference
    (``N(0, 1/fan_in)`` projections, ``N(0, 0.02)`` embedding, zero norm
    weights), not the same numbers: tests that compare the two packages
    go through ``params_from_jax``."""
    device = generator.device
    dtype = torch_dtype(cfg.param_dtype)
    d, vp = cfg.d_model, cfg.padded_vocab
    groups = []
    for kind in cfg.pattern:
        defs = _layer_defs(cfg, kind)
        groups.append({n: _init_leaf(generator, s, i, dtype, device,
                                     lead=(cfg.n_groups,))
                       for n, (s, i) in defs.items()}
                      if cfg.n_groups else {})
    tail = []
    for i in range(cfg.n_tail):
        kind = cfg.layer_kinds[cfg.n_groups * len(cfg.pattern) + i]
        tail.append({n: _init_leaf(generator, s, init, dtype, device)
                     for n, (s, init) in _layer_defs(cfg, kind).items()})
    embed = torch.randn((vp, d), generator=generator, dtype=torch.float32,
                        device=device).mul_(0.02).to(dtype)
    return {
        "embed": embed,
        "unembed": _init_leaf(generator, (d, vp), "fan_in", dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "groups": groups,
        "tail": tail,
    }


def params_from_jax(cfg: ModelConfig, np_params, device="cpu") -> Params:
    """The reference's parameter pytree, with every leaf as a numpy array
    (``jax.tree.map(np.asarray, params)``), -> the port's parameters on
    ``device``. The layouts match leaf for leaf: ``groups`` stacked
    ``[G, ...]`` along the scan axis, ``tail`` a list."""
    for kind in cfg.layer_kinds:
        _check_kind(kind)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return {
        "embed": conv(np_params["embed"]),
        "unembed": conv(np_params["unembed"]),
        "final_norm": conv(np_params["final_norm"]),
        "groups": [{n: conv(x) for n, x in g.items()}
                   for g in np_params["groups"]],
        "tail": [{n: conv(x) for n, x in t.items()}
                 for t in np_params["tail"]],
    }


def params_device(params: Params) -> torch.device:
    return params["embed"].device


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    _check_kind(kind)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, seq_len, hkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, seq_len, hkv, dh), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (batch, seq_len), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cpu") -> Dict[str, List[dict]]:
    dtype = torch_dtype(dtype or cfg.dtype)
    groups = [init_layer_cache(cfg, k, batch, seq_len, dtype, device,
                               lead=(cfg.n_groups,))
              for k in cfg.pattern] if cfg.n_groups else []
    tail = [init_layer_cache(cfg, cfg.layer_kinds[cfg.n_groups *
                                                  len(cfg.pattern) + i],
                             batch, seq_len, dtype, device)
            for i in range(cfg.n_tail)]
    return {"groups": groups, "tail": tail}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
@dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                      # train | prefill | partial | decode
    positions: torch.Tensor        # [B,T] positions of the carried tokens
    chunk_ids: Optional[torch.Tensor] = None   # [B,S] per-key chunk id
    collect_stats: bool = False
    attn_impl: str = "auto"        # backend name, see backend.BACKENDS
    decode_slot: Optional[torch.Tensor] = None  # [B] write slot for decode
    # --- packed multi-request prefill (mode="partial") ------------------
    # Several requests share one sequence row: each token carries a
    # request-local position (RoPE / causality), a cache *slot* (request
    # layout offset + local position), and a segment id.
    slots: Optional[torch.Tensor] = None        # [B,T] cache write slots
    seg_ids: Optional[torch.Tensor] = None      # [B,T] query segment ids
    kv_seg: Optional[torch.Tensor] = None       # [B,S] cache-slot seg ids
    # block-diagonal gather maps (dense path), -1 padding
    pack_qidx: Optional[torch.Tensor] = None    # [R, Amax] -> packed q rows
    pack_kidx: Optional[torch.Tensor] = None    # [R, Smax] -> packed kv slots
    # --- paged decode (pool-twin cache leaves {"kp","vp","ppos"}) -------
    paged_rows: Optional[torch.Tensor] = None        # [B,S] slot rows
    paged_block_rows: Optional[torch.Tensor] = None  # [B,NBmax] block rows
    paged_block_size: int = 0
    # live-row write index, computed once per forward and shared by all
    # layers (the reference's ``mode="drop"`` scatter: -1 rows write
    # nothing)
    _widx: Optional[tuple] = None


def _write_index(ctx: Ctx, wpos: torch.Tensor):
    """(batch idx, token idx, slot) of every row with a slot >= 0: the
    reference scatters with ``mode="drop"``, which torch has no spelling
    for, so the dropped rows are filtered out once per forward."""
    if ctx._widx is None:
        bi, ti = torch.nonzero(wpos >= 0, as_tuple=True)
        ctx._widx = (bi, ti, wpos[bi, ti].long())
    return ctx._widx


def _proj(x, w):
    """x [B,T,d] @ w [d, *out] -> [B,T, *out] (the reference's einsum)."""
    d = w.shape[0]
    out = x.reshape(-1, d) @ w.reshape(d, -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _self_attention(ctx: Ctx, kind: str, p, x, state):
    cfg = ctx.cfg
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = L.apply_rope(q, ctx.positions, cfg.rope_theta)
    k = L.apply_rope(k, ctx.positions, cfg.rope_theta)

    new_state = state
    if ctx.mode == "train":
        k_all, v_all, kv_pos = k, v, ctx.positions
    elif ctx.mode in ("prefill", "partial"):
        # scatter fresh KV into the (possibly pre-populated) cache at its
        # write slots; padding rows (-1) write nothing. Packed prefill
        # supplies explicit slots (request layout offset + local position)
        wpos = ctx.slots if ctx.slots is not None else ctx.positions
        bi, ti, slot = _write_index(ctx, wpos)
        state["k"][bi, slot] = k[bi, ti]
        state["v"][bi, slot] = v[bi, ti]
        state["pos"][bi, slot] = ctx.positions[bi, ti].to(torch.int32)
        k_all, v_all, kv_pos = state["k"], state["v"], state["pos"]
    elif ctx.mode == "decode" and "kp" in state:
        # paged decode: the leaf is the pool twin (flat arena slots shared
        # by every request, no batch axis); decode_slot carries pool-FLAT
        # slot ids, masked rows (-1) write nothing
        bi, _ti, slot = _write_index(ctx, ctx.decode_slot[:, None])
        state["kp"][slot] = k[bi, 0]
        state["vp"][slot] = v[bi, 0]
        state["ppos"][slot] = ctx.positions[bi, 0].to(torch.int32)
        k_all, v_all, kv_pos = state["kp"], state["vp"], state["ppos"]
    elif ctx.mode == "decode":
        # masked batch rows carry slot = -1 and position = -1: the KV
        # write drops and the row's query position masks all attention,
        # so a dead row is inert until a join overwrites it
        bi, ti, slot = _write_index(ctx, ctx.decode_slot[:, None])
        state["k"][bi, slot] = k[bi, ti]
        state["v"][bi, slot] = v[bi, ti]
        state["pos"][bi, slot] = ctx.positions[bi, ti].to(torch.int32)
        k_all, v_all, kv_pos = state["k"], state["v"], state["pos"]
    else:
        raise ValueError(ctx.mode)

    out, row_mass, key_mass = AB.attend(ctx, "global", q, k_all, v_all,
                                        kv_pos)
    B, T = x.shape[:2]
    H, D = out.shape[2:]
    out = (out.reshape(B * T, H * D) @ p["wo"].reshape(H * D, -1)).reshape(
        B, T, -1).to(out.dtype)
    return out, new_state, row_mass, key_mass


def apply_block(ctx: Ctx, kind: str, p, h, state):
    _check_kind(kind)
    cfg = ctx.cfg
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    row_mass = torch.zeros((h.shape[0], h.shape[1], cfg.stats_chunks),
                           dtype=torch.float32, device=h.device)
    key_mass = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32,
                           device=h.device)
    out, state, rm, km = _self_attention(ctx, kind, p, x, state)
    if rm is not None:
        row_mass = rm
    if km is not None and km.shape == key_mass.shape:
        key_mass = km
    h = h + out
    h = h + L.swiglu(L.rms_norm(h, p["ln2"], cfg.norm_eps), p["wi"],
                     p["wo_ff"])
    return h, state, row_mass, key_mass


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------
@dataclass
class ModelOutput:
    logits: torch.Tensor
    cache: Optional[dict] = None
    stats: Optional[torch.Tensor] = None      # [L, B, T, C] row chunk mass
    key_stats: Optional[torch.Tensor] = None  # [L, B, T] mass received/key
    hidden: Optional[torch.Tensor] = None


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    return params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["unembed"].to(torch_dtype(cfg.dtype))
    return (h.reshape(-1, h.shape[-1]) @ w).reshape(*h.shape[:-1], -1)


def run_stack(cfg: ModelConfig, params: Params, h: torch.Tensor, ctx: Ctx,
              cache: Optional[dict] = None, collect_stats: bool = False,
              g0: int = 0, g1: Optional[int] = None, tail: bool = True):
    """Apply layer groups [g0, g1) (+ optional tail) to hidden states h.

    Returns ``(h, cache_window, stats [Lwindow,B,T,C] | None, key_stats
    [Lwindow,B,S] | None)``. ``cache`` is the FULL cache; its window
    [g0, g1) (+ tail) is updated in place and returned as views."""
    pattern = cfg.pattern
    g1 = cfg.n_groups if g1 is None else g1
    want_cache = cache is not None
    stats_list, kstats_list = [], []

    def one(kind, p, st):
        nonlocal h
        h, _st, rm, km = apply_block(ctx, kind, p, h, st)
        if collect_stats:
            stats_list.append(rm)
            kstats_list.append(km)

    for g in range(g0, g1):
        for pi, kind in enumerate(pattern):
            pg = params["groups"][pi]
            p = {n: x[g] for n, x in pg.items()}
            st = ({n: x[g] for n, x in cache["groups"][pi].items()}
                  if want_cache else None)
            one(kind, p, st)
    if tail:
        for i in range(cfg.n_tail):
            kind = cfg.layer_kinds[cfg.n_groups * len(pattern) + i]
            one(kind, params["tail"][i],
                cache["tail"][i] if want_cache else None)

    new_cache = None
    if want_cache:
        new_cache = {
            "groups": [{n: x[g0:g1] for n, x in c.items()}
                       for c in cache["groups"]] if g1 > g0 else [],
            "tail": list(cache["tail"]) if tail else [],
        }
    stats = torch.stack(stats_list) if collect_stats and stats_list \
        else None
    kstats = torch.stack(kstats_list) if collect_stats and kstats_list \
        else None
    return h, new_cache, stats, kstats


def forward(cfg: ModelConfig, params: Params, *,
            tokens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            mode: str = "train",
            cache: Optional[dict] = None,
            chunk_ids: Optional[torch.Tensor] = None,
            collect_stats: bool = False,
            attn_impl: str = "auto",
            decode_slot: Optional[torch.Tensor] = None,
            slots: Optional[torch.Tensor] = None,
            seg_ids: Optional[torch.Tensor] = None,
            kv_seg: Optional[torch.Tensor] = None,
            paged_rows: Optional[torch.Tensor] = None,
            paged_block_rows: Optional[torch.Tensor] = None,
            paged_block_size: int = 0,
            logits_slice: str = "all") -> ModelOutput:
    h = embed_tokens(cfg, params, tokens)
    if h.dim() == 2:
        h = h[:, None]
    B, T = h.shape[:2]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=h.device).expand(B, T)
    ctx = Ctx(cfg=cfg, mode=mode, positions=positions,
              chunk_ids=chunk_ids, collect_stats=collect_stats,
              attn_impl=attn_impl, decode_slot=decode_slot,
              slots=slots, seg_ids=seg_ids, kv_seg=kv_seg,
              paged_rows=paged_rows, paged_block_rows=paged_block_rows,
              paged_block_size=paged_block_size)
    h, new_cache, stats, kstats = run_stack(
        cfg, params, h, ctx, cache=cache, collect_stats=collect_stats)
    if logits_slice == "last":
        h = h[:, -1:]
    logits = lm_head(cfg, params, h)
    return ModelOutput(logits=logits, cache=new_cache, stats=stats,
                       key_stats=kstats, hidden=h)


# Convenience entry points ---------------------------------------------------
def prefill(cfg, params, tokens, positions=None, chunk_ids=None,
            collect_stats=False, attn_impl="auto",
            cache_len: Optional[int] = None):
    B, T = tokens.shape[:2]
    cache = init_cache(cfg, B, cache_len or T,
                       device=params_device(params))
    return forward(cfg, params, tokens=tokens, positions=positions,
                   mode="prefill", cache=cache, chunk_ids=chunk_ids,
                   collect_stats=collect_stats, attn_impl=attn_impl)


def partial_prefill(cfg, params, tokens, positions, cache, chunk_ids=None,
                    collect_stats=False, attn_impl="auto"):
    return forward(cfg, params, tokens=tokens, positions=positions,
                   mode="partial", cache=cache, chunk_ids=chunk_ids,
                   collect_stats=collect_stats, attn_impl=attn_impl)


def decode_step(cfg, params, tokens, positions, cache, decode_slot=None,
                attn_impl="auto", paged_rows=None, paged_block_rows=None,
                paged_block_size=0):
    """tokens [B], positions [B] -> logits [B,1,V] + updated cache."""
    if decode_slot is None:
        decode_slot = positions
    return forward(cfg, params, tokens=tokens[:, None],
                   positions=positions[:, None], mode="decode", cache=cache,
                   decode_slot=decode_slot, attn_impl=attn_impl,
                   paged_rows=paged_rows, paged_block_rows=paged_block_rows,
                   paged_block_size=paged_block_size, logits_slice="last")

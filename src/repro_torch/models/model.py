"""Decoder stack of every family of the reference's registry, in
PyTorch: global ``attn`` and sliding-window ``local`` attention layers,
Griffin's ``rglru`` recurrence and the gated cross-attention ``xattn``
(each with a SwiGLU or MoE FFN), and Mamba2's ``ssd``. The reference's
four execution modes:

  mode="prefill"  full forward, returns per-layer KV cache (+ the
                  Cache-Craft attention statistics when requested)
  mode="partial"  Cache-Craft partial prefill: hidden states exist ONLY
                  for the active tokens (new chunks + recompute +
                  question); cached KV occupies its slots, fresh KV is
                  scattered in, and Q attends across the merged KV with a
                  position mask
  mode="decode"   single-token step against the cache (arena or pool twin)
  mode="train"    full causal forward without a cache, differentiable:
                  remat per layer group (``cfg.remat``) and the SSD
                  intra-chunk term in tensor ops, not the kernel

Parameters are a plain dict of tensors in the reference's layout:
``groups`` is a list (one entry per pattern position) of dicts whose
leaves are stacked ``[G, ...]`` along the reference's scan axis, and
``tail`` a list of per-layer dicts; ``params_from_jax`` turns the
reference pytree (as numpy arrays) into this layout, so both packages
compute the same function in the tests.

Attention caches carry an explicit per-slot position array, so
causality always derives from absolute positions. A ``local`` layer's
cache may be a ring of ``cfg.window`` slots (``ring=True``, the default
of ``init_cache`` / ``prefill``): prefill keeps the last ``window`` tokens
at slot ``pos % window`` and decode writes there too; the serving engine
holds ``local`` layers at full length and applies the window by the mask.
An ``ssd`` layer's cache is its running state ``s`` and the last ``W-1``
conv inputs, an ``rglru`` layer's its state ``h`` and the last ``W-1``
conv inputs (both read back only in decode: a partial pass carries the
state and restarts the conv window from zeros, as the reference does),
and an ``xattn`` layer's the media's K and V (``mk``, ``mv``), written
by any pass given ``media`` and read by the others. The
reference donates caches to its jitted steps; here the cache tensors are
updated IN PLACE (``index_put_`` / ``copy_`` into views of the stacked
leaves) and the returned cache shares storage with the one passed in.

Tensor parallelism (``training/steps.py`` on a mesh with a model axis):
a leaf that ``sharding.tp_plan`` splits over the model axis comes in as
``sharding.Blocks``. A block all-gathers its ``"gather"`` leaves first
and runs replicated; attention with split q heads, the SwiGLU, the MoE
experts and the recurrent blocks (``rglru`` by its rnn channels, ``ssd``
by its heads, its gated norm's statistic summed over the shards) run
once per model shard on its blocks, between ``copy_to_model`` and
``reduce_from_model`` (``distributed/collectives.py``); the embedding
looks up each shard's vocab range and sums. In training ``forward``
leaves the vocab-split logits to the loss (``logits=None``), and
``run_stack_lockstep`` runs the data shards of one microbatch of a
config with experts layer by layer, so that the MoE dispatch of a group
that spans shards sees all of them. The serving steps on a mesh run
``forward_shards`` (the data shards layer by layer, the same dispatch),
their cache leaves as ``sharding.Tiles`` (the blocks of the serving
layout): a split block reads and writes its part of the state
(``_attention_cached``, ``_cross_attention_cached``, ``_rglru_tp``,
``_ssd_tp``), and the last position's vocab-split logits are gathered.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Blocks, Tiles
from repro_torch.models import backend as AB
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# launch code installs the context-parallel mesh through the model module,
# as in the reference; the state lives in the backend layer
set_cp_mesh = AB.set_cp_mesh

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[str(name)]


KINDS = ("attn", "local", "xattn", "rglru", "ssd")


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; known: {KINDS}")


# ---------------------------------------------------------------------------
# Parameter definitions: one source of truth for init, shapes and the
# logical axes the sharding rules resolve (``param_axes``)
# ---------------------------------------------------------------------------
def _ssd_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    d, di, ns, nh, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.conv_width)
    return {
        "ln1": ((d,), ("embed",), "zero"),
        "in_proj": ((d, 2 * di + 2 * ns + nh), ("embed", None), "fan_in"),
        "conv": ((w, di), (None, "rnn"), "fan_in"),
        "A_log": ((nh,), ("ssm_heads",), "ssd_a"),
        "D": ((nh,), ("ssm_heads",), "one"),
        "dt_bias": ((nh,), ("ssm_heads",), "zero"),
        "out_norm": ((di,), ("rnn",), "zero"),
        "out_proj": ((di, d), ("rnn", "embed"), "fan_in"),
    }


def _rglru_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    d, r, w = cfg.d_model, cfg.rnn_width_, cfg.conv_width
    return {
        "ln1": ((d,), ("embed",), "zero"),
        "wx": ((d, r), ("embed", "rnn"), "fan_in"),
        "wy": ((d, r), ("embed", "rnn"), "fan_in"),
        "conv": ((w, r), (None, "rnn"), "fan_in"),
        "lam": ((r,), ("rnn",), "rglru_lambda"),
        "alpha": ((r,), ("rnn",), "one"),
        "beta": ((r,), ("rnn",), "one"),
        "wo_r": ((r, d), ("rnn", "embed"), "fan_in"),
    }


def _layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    """name -> (shape, logical axes, init) of one layer of ``kind``."""
    _check_kind(kind)
    if kind == "ssd":
        return _ssd_defs(cfg)
    d, h, hkv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    if kind == "rglru":
        defs = _rglru_defs(cfg)
    else:
        defs = {
            "ln1": ((d,), ("embed",), "zero"),
            "wq": ((d, h, dh), ("embed", "heads", "q_head_dim"), "fan_in"),
            "wk": ((d, hkv, dh), ("embed", "kv_heads", "kv_head_dim"),
                   "fan_in"),
            "wv": ((d, hkv, dh), ("embed", "kv_heads", "kv_head_dim"),
                   "fan_in"),
            "wo": ((h, dh, d), ("heads", "q_head_dim", "embed"), "fan_in2"),
        }
    if kind == "xattn":
        # tanh gates on the cross-attention and its FFN, zero at init: the
        # layer starts as the identity
        defs["gate_attn"] = ((), (), "zero")
        defs["gate_ffn"] = ((), (), "zero")
    defs["ln2"] = ((d,), ("embed",), "zero")
    if cfg.num_experts:
        e = cfg.num_experts
        # the reference's fan-in for "fan_in" is shape[0]: E for the
        # expert weights, kept as it is
        defs["router"] = ((d, e), ("embed", None), "fan_in")
        defs["wi_e"] = ((e, d, 2, f), ("experts", "embed", None,
                                       "expert_mlp"), "fan_in")
        defs["wo_e"] = ((e, f, d), ("experts", "expert_mlp", "embed"),
                        "fan_in")
    else:
        defs["wi"] = ((d, 2, f), ("embed", None, "mlp"), "fan_in")
        defs["wo_ff"] = ((f, d), ("mlp", "embed"), "fan_in")
    return defs


def _init_leaf(gen, shape, init, dtype, device, lead=()):
    """``lead`` prepends stacking axes (the reference's scan axis) without
    changing the fan-in of the layer's own shape."""
    full = tuple(lead) + tuple(shape)
    if init == "zero":
        return torch.zeros(full, dtype=dtype, device=device)
    if init == "one":
        return torch.ones(full, dtype=dtype, device=device)
    if init == "ssd_a":                     # log U(1, 8): A = -U(1, 8)
        u = torch.rand(full, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log(1.0 + 7.0 * u).to(dtype)
    if init == "rglru_lambda":   # softplus(lam) = -log(u) / c: a = u^r
        u = 0.35 + 0.3 * torch.rand(full, generator=gen, dtype=torch.float32,
                                    device=device)
        return torch.log(torch.expm1(-torch.log(u) / L._RGLRU_C)).to(dtype)
    fan_in = shape[0] if init == "fan_in" else int(np.prod(shape[:2]))
    out = torch.randn(full, generator=gen, dtype=torch.float32,
                      device=device)
    out.mul_(1.0 / np.sqrt(max(1, fan_in)))
    return out if dtype == torch.float32 else out.to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init on ``device``, by default ``generator``'s device (a
    CUDA generator creates the weights directly on the card; the
    full-width model would take minutes to create on the host).
    ``device="meta"`` gives the shapes and dtypes alone, with no memory
    (the dry-run's full-width params). Same distributions as the reference
    (``N(0, 1/fan_in)`` projections, ``N(0, 0.02)`` embedding, zero norm
    weights; for ``ssd`` layers ``A_log = log U(1, 8)``, ``D = 1``, zero
    ``dt_bias``; for ``rglru`` layers ``lam = log(expm1(-log(u) / 8))``
    with u ~ U(0.35, 0.65), so that softplus(lam) = -log(u) / 8, and
    ``alpha = beta = 1``; for ``xattn`` layers the 0-d gates
    ``gate_attn`` and ``gate_ffn`` at zero, which makes the layer the
    identity until they are trained), not the same numbers: tests that
    compare the two packages go through ``params_from_jax``."""
    device = generator.device if device is None else torch.device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d, vp = cfg.d_model, cfg.padded_vocab
    groups = []
    for kind in cfg.pattern:
        defs = _layer_defs(cfg, kind)
        groups.append({n: _init_leaf(generator, s, i, dtype, device,
                                     lead=(cfg.n_groups,))
                       for n, (s, _, i) in defs.items()}
                      if cfg.n_groups else {})
    tail = []
    for i in range(cfg.n_tail):
        kind = cfg.layer_kinds[cfg.n_groups * len(cfg.pattern) + i]
        tail.append({n: _init_leaf(generator, s, init, dtype, device)
                     for n, (s, _, init) in _layer_defs(cfg, kind).items()})
    embed = torch.randn((vp, d), generator=generator, dtype=torch.float32,
                        device=device).mul_(0.02).to(dtype)
    return {
        "embed": embed,
        "unembed": _init_leaf(generator, (d, vp), "fan_in", dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "groups": groups,
        "tail": tail,
    }


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter leaf, a tree shaped like
    ``init_params``'s (the reference's ``param_axes``, tuple for tuple):
    stacked ``groups`` leaves lead with ``None`` for the scan axis. The
    sharding rules resolve it to PartitionSpecs (``sharding.spec_tree``)."""
    def axes(kind, lead=()):
        return {n: lead + a
                for n, (_, a, _) in _layer_defs(cfg, kind).items()}
    return {
        "embed": ("vocab", "embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("embed",),
        "groups": [axes(kind, (None,)) for kind in cfg.pattern],
        "tail": [axes(cfg.layer_kinds[cfg.n_groups * len(cfg.pattern) + i])
                 for i in range(cfg.n_tail)],
    }


def params_from_jax(cfg: ModelConfig, np_params, device) -> Params:
    """The reference's parameter pytree, with every leaf as a numpy array
    (``jax.tree.map(np.asarray, params)``), -> the port's parameters on
    ``device``. The layouts match leaf for leaf: ``groups`` stacked
    ``[G, ...]`` along the scan axis, ``tail`` a list."""
    for kind in cfg.layer_kinds:
        _check_kind(kind)

    def conv(x):
        # bf16 leaves are numpy arrays of ml_dtypes' bfloat16, which torch
        # cannot read: they come across bit for bit through their 16-bit
        # integer view
        x = np.array(x, copy=True)
        if x.dtype.itemsize == 2 and x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(x).to(device)

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
def _kv_len(cfg: ModelConfig, kind: str, seq_len: int,
            ring: bool = True) -> int:
    if kind == "local" and ring:
        return min(seq_len, cfg.window)
    return seq_len


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype, device, lead=(),
                     ring: bool = True) -> Dict[str, torch.Tensor]:
    _check_kind(kind)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    lead = tuple(lead)
    if kind == "ssd":
        return {
            "s": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1,
                                        cfg.d_inner), dtype=dtype,
                                device=device),
        }
    if kind == "rglru":
        r = cfg.rnn_width_
        return {
            "h": torch.zeros(lead + (batch, r), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, r),
                                dtype=dtype, device=device),
        }
    if kind == "xattn":
        m = cfg.num_media_tokens
        return {n: torch.zeros(lead + (batch, m, hkv, dh), dtype=dtype,
                               device=device) for n in ("mk", "mv")}
    seq_len = _kv_len(cfg, kind, seq_len, ring)
    return {
        "k": torch.zeros(lead + (batch, seq_len, hkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, seq_len, hkv, dh), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (batch, seq_len), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               *, device, ring: bool = True) -> Dict[str, List[dict]]:
    """``ring=True`` sizes ``local`` layers' caches at ``min(seq_len,
    window)`` slots, as the reference does; ``ring=False`` at
    ``seq_len``."""
    dtype = torch_dtype(dtype or cfg.dtype)
    groups = [init_layer_cache(cfg, k, batch, seq_len, dtype, device,
                               lead=(cfg.n_groups,), ring=ring)
              for k in cfg.pattern] if cfg.n_groups else []
    tail = [init_layer_cache(cfg, cfg.layer_kinds[cfg.n_groups *
                                                  len(cfg.pattern) + i],
                             batch, seq_len, dtype, device, ring=ring)
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
    media: Optional[torch.Tensor] = None       # [B,M,d] xattn memory
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
    # tokens of the global microbatch a data shard's rows belong to: the
    # MoE groups and capacity follow it (None: this call's own tokens)
    moe_tokens: Optional[int] = None
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


def _out_proj(out, wo):
    """Attention output [B,T,H,D] @ wo [H,D,d] -> [B,T,d]."""
    B, T, H, D = out.shape
    return (out.reshape(B * T, H * D) @ wo.reshape(H * D, -1)).reshape(
        B, T, -1).to(out.dtype)


def _laid_out(state) -> bool:
    return state is not None and any(isinstance(v, Tiles)
                                     for v in state.values())


def _self_attention(ctx: Ctx, kind: str, p, x, state):
    cfg = ctx.cfg
    if isinstance(p["wq"], Blocks) and ctx.mode == "train":
        return _attention_tp(ctx, kind, p, x), state, None, None
    if isinstance(p["wq"], Blocks) or _laid_out(state):
        return _attention_cached(ctx, kind, p, x, state), state, None, None
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = L.apply_rope(q, ctx.positions, cfg.rope_theta)
    k = L.apply_rope(k, ctx.positions, cfg.rope_theta)

    # a fresh K/V written into a cache takes the cache's dtype, as the
    # reference's ``.at[].set`` does (a bf16 model over fp32 caches: the
    # engine's and the executor's are fp32)
    new_state = state
    if ctx.mode == "train":
        k_all, v_all, kv_pos = k, v, ctx.positions
    elif ctx.mode in ("prefill", "partial") and kind == "local" and \
            state["k"].shape[1] < x.shape[1]:
        # a ring cache shorter than the prompt (decode-oriented): keep the
        # last `window` tokens at slot pos % window; attention itself runs
        # over the fresh full KV
        w = state["k"].shape[1]
        pos = ctx.positions[:, -w:]
        bi = torch.arange(x.shape[0], device=x.device)[:, None]
        slot = (pos % w).long()
        state["k"][bi, slot] = k[:, -w:].to(state["k"].dtype)
        state["v"][bi, slot] = v[:, -w:].to(state["v"].dtype)
        state["pos"][bi, slot] = pos.to(torch.int32)
        k_all, v_all, kv_pos = k, v, ctx.positions
    elif ctx.mode in ("prefill", "partial"):
        # scatter fresh KV into the (possibly pre-populated) cache at its
        # write slots; padding rows (-1) write nothing. Packed prefill
        # supplies explicit slots (request layout offset + local position)
        wpos = ctx.slots if ctx.slots is not None else ctx.positions
        bi, ti, slot = _write_index(ctx, wpos)
        state["k"][bi, slot] = k[bi, ti].to(state["k"].dtype)
        state["v"][bi, slot] = v[bi, ti].to(state["v"].dtype)
        state["pos"][bi, slot] = ctx.positions[bi, ti].to(torch.int32)
        k_all, v_all, kv_pos = state["k"], state["v"], state["pos"]
    elif ctx.mode == "decode" and "kp" in state:
        # paged decode: the leaf is the pool twin (flat arena slots shared
        # by every request, no batch axis); decode_slot carries pool-FLAT
        # slot ids, masked rows (-1) write nothing
        bi, _ti, slot = _write_index(ctx, ctx.decode_slot[:, None])
        state["kp"][slot] = k[bi, 0].to(state["kp"].dtype)
        state["vp"][slot] = v[bi, 0].to(state["vp"].dtype)
        state["ppos"][slot] = ctx.positions[bi, 0].to(torch.int32)
        k_all, v_all, kv_pos = state["kp"], state["vp"], state["ppos"]
    elif ctx.mode == "decode":
        # masked batch rows carry slot = -1 and position = -1: the KV
        # write drops and the row's query position masks all attention,
        # so a dead row is inert until a join overwrites it; a local
        # layer's ring takes the slot mod its length
        bi, ti, slot = _write_index(ctx, ctx.decode_slot[:, None])
        if kind == "local":
            slot = slot % state["k"].shape[1]
        state["k"][bi, slot] = k[bi, ti].to(state["k"].dtype)
        state["v"][bi, slot] = v[bi, ti].to(state["v"].dtype)
        state["pos"][bi, slot] = ctx.positions[bi, ti].to(torch.int32)
        k_all, v_all, kv_pos = state["k"], state["v"], state["pos"]
    else:
        raise ValueError(ctx.mode)

    out, row_mass, key_mass = AB.attend(ctx, kind, q, k_all, v_all, kv_pos)
    return _out_proj(out, p["wo"]), new_state, row_mass, key_mass


def _cross_attend(q, mk, mv):
    """Cross-attention of q [B,Tq,H,D] to the media's K and V (no RoPE,
    no mask): dense up to 2^21 score elements, blocked flash past them,
    as the reference."""
    B, Tq = q.shape[:2]
    M = mk.shape[1]
    if Tq * M <= (1 << 21):
        mask = torch.ones((B, Tq, M), dtype=torch.bool, device=q.device)
        return L.gqa_attend_dense(q, mk, mv, mask)[0]
    # every (query, key) pair live: query positions 1, key positions 0
    return L.gqa_attend_flash(
        q, mk, mv, torch.ones((B, Tq), dtype=torch.int32, device=q.device),
        torch.zeros((B, M), dtype=torch.int32, device=q.device))


def _attention_tp(ctx: Ctx, kind: str, p, x):
    """Train-mode attention with the q heads split over the model axis
    (Megatron): model shard m projects its q heads from its copy of
    ``x``, attends them to their kv heads and projects them out with its
    rows of ``wo``; the shards' outputs are summed (``reduce_from_model``).
    Where the kv heads split too, each shard projects its own; else the
    kv projection runs once, replicated, and each shard takes the kv head
    of every q head it holds (``copy_to_model``)."""
    cfg = ctx.cfg
    wq, wo = p["wq"].parts, p["wo"].parts
    n = len(wq)
    xs = CO.copy_to_model(x, n)
    cross = kind == "xattn"

    def kv(src, wk, wv):
        k, v = _proj(src, wk), _proj(src, wv)
        if not cross:
            k = L.apply_rope(k, ctx.positions, cfg.rope_theta)
        return k, v

    if isinstance(p["wk"], Blocks):
        # the media need no gradient: every shard reads the same tensor
        kvs = [kv(ctx.media if cross else xs[m], p["wk"].parts[m],
                  p["wv"].parts[m]) for m in range(n)]
    else:
        k, v = kv(ctx.media if cross else x, p["wk"], p["wv"])
        ks, vs = CO.copy_to_model(k, n), CO.copy_to_model(v, n)
        group = cfg.num_heads // cfg.num_kv_heads
        kvs, h0 = [], 0
        for m in range(n):
            idx = torch.arange(h0, h0 + wq[m].shape[1],
                               device=x.device) // group
            kvs.append((ks[m].index_select(2, idx),
                        vs[m].index_select(2, idx)))
            h0 += wq[m].shape[1]
    outs = []
    for m in range(n):
        q = _proj(xs[m], wq[m])
        if cross:
            out = _cross_attend(q, *kvs[m])
        else:
            q = L.apply_rope(q, ctx.positions, cfg.rope_theta)
            out = AB.attend(ctx, kind, q, *kvs[m], ctx.positions)[0]
        outs.append(_out_proj(out, wo[m]))
    return CO.reduce_from_model(outs)


def _ranges(sizes) -> list:
    """(start, stop) of consecutive blocks of ``sizes``."""
    out, a = [], 0
    for n in sizes:
        out.append((a, a + n))
        a += n
    return out


def _kv_of(t, heads, group: int):
    """The kv heads of ``t`` [B,S,Hkv,D] that the q heads ``heads``
    (start, stop) attend to, as a tensor of its own: their contiguous
    range where each serves the same number of consecutive q heads (the
    GQA grouping kept), else one kv head per q head."""
    h0, h1 = heads
    a, b = h0 // group, (h1 - 1) // group + 1
    n = (h1 - h0) // (b - a)
    if n * (b - a) == h1 - h0 and all(
            j // group - a == (j - h0) // n for j in range(h0, h1)):
        return t[:, :, a:b].contiguous()
    return t.index_select(2, torch.arange(h0, h1, device=t.device) // group)


def _attention_cached(ctx: Ctx, kind: str, p, x, state):
    """Serving-mode attention with the q heads split over the model axis
    (``p["wq"]`` a ``Blocks``), or a cache laid out on a mesh
    (``sharding.Tiles`` leaves), or both: model shard m projects its q
    heads from its copy of ``x`` and attends them on its own operands with
    ``backend.attend`` (one kernel launch per shard on ``kernel``); the
    shards' outputs are summed. Where the kv heads split too, shard m
    projects its kv heads and writes them into its block of the cache,
    where it also reads them. Where they do not, K and V are projected
    whole (the plan's ``"gather"`` kv weights, as in training), each
    cache block takes its part of the write (its D columns, or the slots
    of its sequence range), and attention reads the cache put together
    (``collectives.read``, a counted gather: attention never contracts a
    split head dim). A ``local`` ring shorter than the prompt keeps the
    last ``window`` tokens at slot ``pos % window`` and attention runs over
    the fresh K and V, as in ``_self_attention``."""
    cfg = ctx.cfg
    if ctx.mode == "decode" and "kp" in state:
        raise ValueError("paged decode with the heads split over the model "
                         "axis: the engine's serving mesh does that "
                         "(backend 'sharded' / 'paged_kernel')")
    split = isinstance(p["wq"], Blocks)
    wq = p["wq"].parts if split else [p["wq"]]
    wo = p["wo"].parts if split else [p["wo"]]
    n = len(wq)
    xs = CO.copy_to_model(x, n)
    heads = _ranges(w.shape[1] for w in wq)
    group = cfg.num_heads // cfg.num_kv_heads
    pos = ctx.positions

    def rope(t):
        return L.apply_rope(t, pos, cfg.rope_theta)
    if isinstance(p["wk"], Blocks):
        kvr = _ranges(w.shape[1] for w in p["wk"].parts)
        fresh = [(rope(_proj(xs[m], p["wk"].parts[m])),
                  _proj(xs[m], p["wv"].parts[m]), kvr[m]) for m in range(n)]
    else:
        fresh = [(rope(_proj(x, p["wk"])), _proj(x, p["wv"]),
                  (0, cfg.num_kv_heads))]
    S_c = state["k"].shape[1]
    ring_short = ctx.mode in ("prefill", "partial") and kind == "local" \
        and S_c < x.shape[1]
    if ring_short:
        B, w = x.shape[0], S_c
        bi = torch.arange(B, device=x.device)[:, None].expand(B, w)
        slot = (pos[:, -w:] % w).long()
        bi, slot = bi.reshape(-1), slot.reshape(-1)
        rows = (slice(None), slice(x.shape[1] - w, None))
        wpos = pos[:, -w:].reshape(-1)
    else:
        if ctx.mode == "decode":
            bi, ti, slot = _write_index(ctx, ctx.decode_slot[:, None])
            if kind == "local":
                slot = slot % S_c
        elif ctx.mode in ("prefill", "partial"):
            bi, ti, slot = _write_index(
                ctx, ctx.slots if ctx.slots is not None else pos)
        else:
            raise ValueError(ctx.mode)
        rows = (bi, ti)
        wpos = pos[bi, ti]
    for k, v, hr in fresh:
        tail = (hr, (0, k.shape[-1]))
        kw, vw = k[rows], v[rows]
        SH.tiles_scatter(state["k"], bi, slot, kw.reshape(-1, *kw.shape[-2:]),
                         tail)
        SH.tiles_scatter(state["v"], bi, slot, vw.reshape(-1, *vw.shape[-2:]),
                         tail)
    SH.tiles_scatter(state["pos"], bi, slot, wpos.to(torch.int32))

    def cache(name, hr, m):
        shape = state[name].shape
        region = SH.full_region(shape, {2: hr} if name != "pos" else None)
        return CO.read(state[name], region, "kv", prefer=m)
    whole = None
    if len(fresh) == 1 and not ring_short:
        whole = (cache("k", fresh[0][2], 0), cache("v", fresh[0][2], 0),
                 cache("pos", None, 0))
    outs = []
    for m in range(n):
        if ring_short:
            k, v, hr = fresh[m] if len(fresh) > 1 else fresh[0]
            if len(fresh) == 1:
                k, v = _kv_of(k, heads[m], group), _kv_of(v, heads[m], group)
            kv_pos = pos
        elif whole is None:
            with CO.counting(CO.is_counting() and m == 0):
                k, v, kv_pos = (cache("k", fresh[m][2], m),
                                cache("v", fresh[m][2], m),
                                cache("pos", None, m))
        else:
            k, v = (_kv_of(t, heads[m], group) for t in whole[:2])
            kv_pos = whole[2]
        q = rope(_proj(xs[m], wq[m]))
        out = AB.attend(ctx, kind, q, k, v, kv_pos)[0]
        outs.append(_out_proj(out, wo[m]))
    return CO.reduce_from_model(outs)


def _cross_attention_cached(ctx: Ctx, p, x, state):
    """Cross-attention with the q heads split over the model axis, or a
    cache laid out on a mesh (``_attention_cached``'s split): a pass given
    ``media`` projects the media's K and V (each shard its kv heads where
    they split, else whole) and writes them into the cache's blocks; any
    other pass reads them (put together where the blocks split what a
    shard reads, a counted gather). Without ``tanh(gate_attn)``."""
    cfg = ctx.cfg
    split = isinstance(p["wq"], Blocks)
    wq = p["wq"].parts if split else [p["wq"]]
    wo = p["wo"].parts if split else [p["wo"]]
    n = len(wq)
    xs = CO.copy_to_model(x, n)
    heads = _ranges(w.shape[1] for w in wq)
    group = cfg.num_heads // cfg.num_kv_heads
    kv_split = isinstance(p["wk"], Blocks)
    kvr = _ranges(w.shape[1] for w in p["wk"].parts) if kv_split \
        else [(0, cfg.num_kv_heads)]
    wks = p["wk"].parts if kv_split else [p["wk"]]
    wvs = p["wv"].parts if kv_split else [p["wv"]]
    if ctx.mode in ("prefill", "partial") and ctx.media is not None:
        kvs = [(_proj(ctx.media, a), _proj(ctx.media, b))
               for a, b in zip(wks, wvs)]
        if state is not None:
            for (mk, mv), hr in zip(kvs, kvr):
                for name, t in (("mk", mk), ("mv", mv)):
                    SH.tiles_put(state[name], SH.full_region(
                        state[name].shape, {2: hr}), t)
    else:
        kvs = []
        for j, hr in enumerate(kvr):
            with CO.counting(CO.is_counting() and j == 0):
                kvs.append(tuple(CO.read(state[name], SH.full_region(
                    state[name].shape, {2: hr}), "kv", prefer=j)
                    for name in ("mk", "mv")))
    outs = []
    for m in range(n):
        mk, mv = kvs[m] if kv_split else (
            _kv_of(t, heads[m], group) for t in kvs[0])
        out = _cross_attend(_proj(xs[m], wq[m]), mk, mv)
        outs.append(_out_proj(out, wo[m]))
    return CO.reduce_from_model(outs)


def _cross_attention(ctx: Ctx, p, x, state):
    """Gated cross-attention to the media (``_cross_attend``): a pass
    given ``media`` projects its K and V (and stores them in the cache,
    when there is one), any other pass reads them from the cache.
    Returns ``tanh(gate_attn)`` x the attention output."""
    if isinstance(p["wq"], Blocks) and state is None:
        return torch.tanh(p["gate_attn"]) * _attention_tp(
            ctx, "xattn", p, x), state
    if isinstance(p["wq"], Blocks) or _laid_out(state):
        return torch.tanh(p["gate_attn"]) * _cross_attention_cached(
            ctx, p, x, state), state
    q = _proj(x, p["wq"])
    if ctx.mode in ("train", "prefill", "partial") and \
            ctx.media is not None:
        mk = _proj(ctx.media, p["wk"])
        mv = _proj(ctx.media, p["wv"])
        if state is not None:
            state["mk"].copy_(mk)
            state["mv"].copy_(mv)
    else:
        mk, mv = state["mk"], state["mv"]
    out = _out_proj(_cross_attend(q, mk, mv), p["wo"])
    return torch.tanh(p["gate_attn"]) * out, state


def _ffn(ctx: Ctx, p, x):
    """The SwiGLU FFN; with ``wi`` split over the model axis, each shard's
    columns of ``wi`` and rows of ``wo_ff`` on its copy of ``x``, summed
    (Megatron)."""
    wi, wo = p["wi"], p["wo_ff"]
    if isinstance(wi, Blocks):
        xs = CO.copy_to_model(x, len(wi.parts))
        return CO.reduce_from_model([L.swiglu(xm, a, b) for xm, a, b in
                                     zip(xs, wi.parts, wo.parts)])
    return L.swiglu(x, wi, wo)


def _moe_route(ctx: Ctx, p, h):
    """The MoE FFN up to its router: (the FFN's normed input grouped
    [Gs, gs, d], router probs, gates, expert ids), grouped by
    ``L.moe_groups`` over the global microbatch (``ctx.moe_tokens``)."""
    cfg = ctx.cfg
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    d = x.shape[-1]
    T = x.numel() // d
    _, gs = L.moe_groups(T, total=ctx.moe_tokens)
    xg = x.reshape(T // gs, gs, d)
    return (xg,) + L.moe_route(xg, p["router"], cfg.experts_per_token)


def _moe_capacity(ctx: Ctx, xg) -> int:
    cfg = ctx.cfg
    g, _ = L.moe_groups(xg.shape[0] * xg.shape[1], total=ctx.moe_tokens)
    return L.moe_capacity(g, cfg.experts_per_token, cfg.capacity_factor,
                          cfg.num_experts)


def _moe_apply(ctx: Ctx, kind: str, p, h, xg, gate_vals, gate_idx, slot,
               kept):
    """The MoE experts on the dispatch ``slot`` / ``kept`` and the residual:
    with the experts split over the model axis, each shard runs its own
    on its copy of the tokens and gates, and the partial combines are
    summed."""
    C = _moe_capacity(ctx, xg)
    wi, wo = p["wi_e"], p["wo_e"]
    if isinstance(wi, Blocks):
        n = len(wi.parts)
        xs = CO.copy_to_model(xg, n)
        gvs = CO.copy_to_model(gate_vals, n)
        parts, e0 = [], 0
        for m in range(n):
            parts.append(L.moe_experts(xs[m], gvs[m], gate_idx, slot, kept,
                                       wi.parts[m], wo.parts[m], C, e0))
            e0 += wi.parts[m].shape[0]
        out = CO.reduce_from_model(parts)
    else:
        out = L.moe_experts(xg, gate_vals, gate_idx, slot, kept, wi, wo, C)
    y = out.reshape(h.shape).to(h.dtype)
    if kind == "xattn":
        y = torch.tanh(p["gate_ffn"]) * y
    return h + y


def _rglru_tp(ctx: Ctx, p, x, state=None):
    """The RG-LRU block with its rnn channels split over the model axis
    (Megatron): model shard m runs the gate, the input branch, the
    depthwise conv and the channelwise RG-LRU on its columns of ``wy`` /
    ``wx`` from its copy of ``x`` and projects them out with its rows of
    ``wo_r``; the shards' outputs are summed. Given a cache, shard m
    reads and writes its channels of ``h`` and ``conv`` (a tensor's
    slice, or its block of a ``sharding.Tiles``), as ``_rglru_block``
    reads and writes the whole."""
    xs = CO.copy_to_model(x, len(p["wx"].parts))
    decode = ctx.mode == "decode"
    outs, c0 = [], 0
    for m, xm in enumerate(xs):
        pm = {k: v.parts[m] for k, v in p.items() if isinstance(v, Blocks)}
        ch = (c0, c0 + pm["lam"].shape[0])
        c0 = ch[1]
        gate = F.gelu(_proj(xm, pm["wy"]), approximate="tanh")
        conv_state = _state(state, "conv", {2: ch}, m) if decode else None
        b, new_conv = L.causal_conv1d(_proj(xm, pm["wx"]), pm["conv"],
                                      conv_state)
        if decode:
            y, h = L.rglru_step(b[:, 0], pm["lam"], pm["alpha"], pm["beta"],
                                _state(state, "h", {1: ch}, m))
            y = y[:, None]
        else:
            h0 = _state(state, "h", {1: ch}, m) if ctx.mode == "partial" \
                else None
            y, h = L.rglru_scan(b, pm["lam"], pm["alpha"], pm["beta"], h0)
        outs.append(_proj(gate * y, pm["wo_r"]))
        if state is not None:
            SH.tiles_put(state["h"], SH.full_region(state["h"].shape,
                                                    {1: ch}), h)
            SH.tiles_put(state["conv"], SH.full_region(
                state["conv"].shape, {2: ch}), new_conv)
    return CO.reduce_from_model(outs)


def _state(state, name: str, fixed: dict, m: int):
    """Model shard m's part (``fixed``: {dim: (start, stop)}) of a cache
    leaf, or None without a cache."""
    if state is None:
        return None
    return CO.read(state[name], SH.full_region(state[name].shape, fixed),
                   "state", prefer=m)


def _rglru_block(ctx: Ctx, p, x, state):
    """Griffin recurrent block: a GeLU gate times the RG-LRU over the
    causal conv of the input branch. As in the reference, the conv state
    is read only in decode (a partial pass restarts the conv window from
    zeros), the recurrent state ``h`` in decode and partial. A cache,
    when given, is written in place."""
    if isinstance(p["wx"], Blocks):
        return _rglru_tp(ctx, p, x, state), state
    gate = F.gelu(_proj(x, p["wy"]), approximate="tanh")
    b = _proj(x, p["wx"])
    conv_state = state["conv"] if (state is not None and
                                   ctx.mode == "decode") else None
    b, new_conv = L.causal_conv1d(b, p["conv"], conv_state)
    if ctx.mode == "decode":
        y, h = L.rglru_step(b[:, 0], p["lam"], p["alpha"], p["beta"],
                            state["h"])
        y = y[:, None]
    else:
        h0 = state["h"] if (state is not None and ctx.mode == "partial") \
            else None
        y, h = L.rglru_scan(b, p["lam"], p["alpha"], p["beta"], h0)
    out = _proj(gate * y, p["wo_r"])
    if state is not None:
        state["h"].copy_(h)
        state["conv"].copy_(new_conv)
    return out, state


def _ssd_tp(ctx: Ctx, p, x, state=None):
    """The SSD block with its heads (and their channels) split over the
    model axis (Megatron). The whole ``in_proj`` runs once, replicated, as
    in the reference; each model shard takes from its copy of the
    projection its channels of ``z`` and ``xs``, its heads of ``dt`` and
    all of ``B`` and ``C``, and runs the conv, the SSD scan and the gated
    norm on them. The norm's statistic spans all of ``d_inner``: the
    shards' sums of squares are summed over the model axis
    (``sum_over_model``, an all-reduce of [B, T] fp32 each way), then each
    shard projects out with its rows of ``out_proj`` and the outputs are
    summed. Given a cache, shard m reads and writes its heads of ``s``
    and its channels of ``conv``, as ``_ssd_block`` the whole: the conv
    state in decode, ``ssd_step`` in decode and ``ssd_chunked`` from
    ``s`` in partial (the ``ssd_intra`` kernel on CUDA tensors outside
    training)."""
    cfg = ctx.cfg
    di, ns, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    ps = CO.copy_to_model(_proj(x, p["in_proj"]), len(p["out_proj"].parts))
    B_, T = x.shape[:2]
    decode = ctx.mode == "decode"
    ys, zs, c0, h0 = [], [], 0, 0
    for m, pr in enumerate(ps):
        pm = {k: v.parts[m] for k, v in p.items() if isinstance(v, Blocks)}
        w, k = pm["conv"].shape[1], pm["A_log"].shape[0]
        if w != k * pd:
            raise ValueError(f"model shard {m} holds {w} channels of "
                             f"{k} heads of {pd}")
        z, xs, Bm, Cm, dt = (pr[..., a:a + b] for a, b in (
            (c0, w), (di + c0, w), (2 * di, ns), (2 * di + ns, ns),
            (2 * di + 2 * ns + h0, k)))
        ch, hh = (c0, c0 + w), (h0, h0 + k)
        conv_state = _state(state, "conv", {2: ch}, m) if decode else None
        xs, new_conv = L.causal_conv1d(xs, pm["conv"], conv_state)
        xs = F.silu(xs)
        dt = F.softplus(dt + pm["dt_bias"])
        if decode:
            y, s = L.ssd_step(xs.reshape(B_, T, k, pd)[:, 0], dt[:, 0],
                              pm["A_log"], Bm[:, 0], Cm[:, 0], pm["D"],
                              _state(state, "s", {1: hh}, m))
            y = y[:, None]
        else:
            s0 = _state(state, "s", {1: hh}, m) if ctx.mode == "partial" \
                else None
            y, s = L.ssd_chunked(xs.reshape(B_, T, k, pd), dt, pm["A_log"],
                                 Bm, Cm, pm["D"], cfg.ssd_chunk, s0,
                                 train=ctx.mode == "train")
        if state is not None:
            SH.tiles_put(state["s"], SH.full_region(state["s"].shape,
                                                    {1: hh}), s)
            SH.tiles_put(state["conv"], SH.full_region(
                state["conv"].shape, {2: ch}), new_conv)
        ys.append(y.reshape(B_, T, w))
        zs.append(z)
        c0, h0 = c0 + w, h0 + k
    sums = CO.sum_over_model([y.float().square().sum(-1, keepdim=True)
                              for y in ys])
    outs = []
    for y, z, ss, w_n, w_o in zip(ys, zs, sums, p["out_norm"].parts,
                                  p["out_proj"].parts):
        yn = y.float() * torch.rsqrt(ss / di + cfg.norm_eps)
        yn = (yn * (1.0 + w_n.float())).to(y.dtype)
        outs.append(_proj(yn * F.silu(z), w_o))
    return CO.reduce_from_model(outs)


def _ssd_block(ctx: Ctx, p, x, state):
    """Mamba2 block. The conv state is read only in decode; prefill stores
    the last W-1 pre-conv inputs. A cache, when given, is written in
    place."""
    if isinstance(p["out_proj"], Blocks):
        return _ssd_tp(ctx, p, x, state), state
    cfg = ctx.cfg
    di, ns, nh, pd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim)
    proj = _proj(x, p["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    conv_state = state["conv"] if (state is not None and
                                   ctx.mode == "decode") else None
    xs, new_conv = L.causal_conv1d(xs, p["conv"], conv_state)
    xs = F.silu(xs)
    dt = F.softplus(dt + p["dt_bias"])
    B_, T = xs.shape[:2]
    xh = xs.reshape(B_, T, nh, pd)
    if ctx.mode == "decode":
        y, s = L.ssd_step(xh[:, 0], dt[:, 0], p["A_log"], Bm[:, 0], Cm[:, 0],
                          p["D"], state["s"])
        y = y[:, None]
    else:
        s0 = state["s"] if (state is not None and ctx.mode == "partial") \
            else None
        y, s = L.ssd_chunked(xh, dt, p["A_log"], Bm, Cm, p["D"],
                             cfg.ssd_chunk, s0, train=ctx.mode == "train")
    y = y.reshape(B_, T, di)
    y = L.rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = _proj(y, p["out_proj"])
    if state is not None:
        state["s"].copy_(s)
        state["conv"].copy_(new_conv)
    return out, state


def _whole(p):
    """A layer's leaves with its ``"gather"`` blocks all-gathered over the
    model axis (``gather_over_model``), so that the block runs them
    replicated."""
    return {n: CO.gather_over_model(v.parts, v.dim)
            if isinstance(v, Blocks) and v.route == "gather" else v
            for n, v in p.items()}


def _mixer(ctx: Ctx, kind: str, p, h, state):
    """The block before its FFN: (h + mixer output, state, row mass, key
    mass); the masses zero where the mixer gives none."""
    cfg = ctx.cfg
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    row_mass = torch.zeros((h.shape[0], h.shape[1], cfg.stats_chunks),
                           dtype=torch.float32, device=h.device)
    key_mass = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32,
                           device=h.device)
    if kind == "ssd":                   # no FFN, no attention statistics
        out, state = _ssd_block(ctx, p, x, state)
    elif kind == "xattn":
        out, state = _cross_attention(ctx, p, x, state)
    elif kind == "rglru":
        out, state = _rglru_block(ctx, p, x, state)
    else:
        out, state, rm, km = _self_attention(ctx, kind, p, x, state)
        if rm is not None:
            row_mass = rm
        if km is not None and km.shape == key_mass.shape:
            key_mass = km
    return h + out, state, row_mass, key_mass


def apply_block(ctx: Ctx, kind: str, p, h, state):
    """One layer: (h, state, row mass, key mass, the router probs of a
    MoE layer or None)."""
    _check_kind(kind)
    cfg = ctx.cfg
    p = _whole(p)
    h, state, row_mass, key_mass = _mixer(ctx, kind, p, h, state)
    if kind == "ssd":
        return h, state, row_mass, key_mass, None
    if cfg.num_experts:
        xg, probs, gate_vals, gate_idx = _moe_route(ctx, p, h)
        slot, kept = L.moe_slots(gate_idx, _moe_capacity(ctx, xg),
                                 cfg.num_experts)
        h = _moe_apply(ctx, kind, p, h, xg, gate_vals, gate_idx, slot, kept)
        return h, state, row_mass, key_mass, probs
    y = _ffn(ctx, p, L.rms_norm(h, p["ln2"], cfg.norm_eps))
    if kind == "xattn":
        y = torch.tanh(p["gate_ffn"]) * y
    return h + y, state, row_mass, key_mass, None


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------
def _remat(fn, *args, whole: bool = True):
    """``fn(*args)`` checkpointed: only the inputs are kept, and the
    backward pass runs ``fn`` again; ``whole``, to its end (no early stop:
    the collectives at a sharded group's end recompute as GSPMD's remat
    recomputes them)."""
    with set_checkpoint_early_stop(not whole):
        return checkpoint(fn, *args, use_reentrant=False)


@dataclass
class ModelOutput:
    logits: torch.Tensor
    cache: Optional[dict] = None
    stats: Optional[torch.Tensor] = None      # [L, B, T, C] row chunk mass
    key_stats: Optional[torch.Tensor] = None  # [L, B, T] mass received/key
    # the MoE load-balancing loss summed over layers: a tensor, or the
    # number 0.0 without experts
    aux_loss: Any = 0.0
    hidden: Optional[torch.Tensor] = None


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    # F.embedding rather than indexing: its backward sums the rows of a
    # repeated token in a fixed order on the CPU too (an indexed gather's
    # backward accumulates across threads there), so a train step gives
    # the same bytes every run
    dtype = torch_dtype(cfg.dtype)
    w = params["embed"]
    if not isinstance(w, Blocks):
        return F.embedding(tokens.long(), w.to(dtype))
    # vocab split over the model axis: each shard looks up the tokens of
    # its range and writes zeros elsewhere; the shards' rows are summed
    tok, parts, lo = tokens.long(), [], 0
    for blk in w.parts:
        n = blk.shape[0]
        mine = (tok >= lo) & (tok < lo + n)
        e = F.embedding((tok - lo).clamp(0, max(n - 1, 0)), blk.to(dtype))
        parts.append(torch.where(mine[..., None], e, torch.zeros(
            (), dtype=dtype, device=e.device)))
        lo += n
    return CO.reduce_from_model(parts)


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor):
    """The vocabulary's logits. With ``unembed`` split by vocab over the
    model axis, each shard's block of the logits, gathered over the shards
    (``collectives.gather_logits``, counted); the tensor-parallel train
    step never calls this, its vocab-parallel loss has the blocks
    (``training/steps.py``)."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    dtype = torch_dtype(cfg.dtype)
    w = params["unembed"]
    if isinstance(w, Blocks):
        hs = h.reshape(-1, h.shape[-1])
        return CO.gather_logits([(hs @ b.to(dtype)).reshape(
            *h.shape[:-1], -1) for b in w.parts])
    w = w.to(dtype)
    return (h.reshape(-1, h.shape[-1]) @ w).reshape(*h.shape[:-1], -1)


def run_stack(cfg: ModelConfig, params: Params, h: torch.Tensor, ctx: Ctx,
              cache: Optional[dict] = None, collect_stats: bool = False,
              g0: int = 0, g1: Optional[int] = None, tail: bool = True,
              moe_probs: Optional[list] = None):
    """Apply layer groups [g0, g1) (+ optional tail) to hidden states h.

    Returns ``(h, cache_window, stats [Lwindow,B,T,C] | None, key_stats
    [Lwindow,B,S] | None, aux)``, ``aux`` the window's MoE loss summed
    over layers. ``cache`` is the FULL cache; its window [g0, g1) (+ tail)
    is updated in place and returned as views. ``moe_probs``, a list,
    gets each MoE layer's router probs in layer order."""
    pattern = cfg.pattern
    g1 = cfg.n_groups if g1 is None else g1
    want_cache = cache is not None
    stats_list, kstats_list = [], []
    # per-layer views of the stacked [G, ...] leaves, made by one unbind
    # per leaf: in training their gradients meet in one stack into the
    # stacked leaf (indexing x[g] per layer would add a full-size zero
    # gradient per layer)
    layers = [{n: x.unbind() if isinstance(x, Blocks) else x.unbind(0)
               for n, x in pg.items()}
              for pg in params["groups"]] if g1 > g0 else []

    def group(h, g):
        masses, probs = [], []
        for pi, kind in enumerate(pattern):
            p = {n: xs[g] for n, xs in layers[pi].items()}
            st = ({n: x[g] for n, x in cache["groups"][pi].items()}
                  if want_cache else None)
            h, _st, rm, km, pr = apply_block(ctx, kind, p, h, st)
            masses.append((rm, km))
            if pr is not None:
                probs.append(pr)
        return h, masses, probs

    def keep(masses, probs):
        """The statistics kept, and the MoE loss of ``probs``' layers."""
        if collect_stats:
            stats_list.extend(rm for rm, _ in masses)
            kstats_list.extend(km for _, km in masses)
        if moe_probs is not None:
            moe_probs.extend(probs)
        aux = 0.0
        for pr in probs:
            aux = aux + L.moe_aux_loss(pr, cfg.num_experts)
        return aux

    # remat per layer group in training, as the reference's jax.checkpoint
    # (``_remat``, whole where the group holds tensor-parallel blocks):
    # only the group's input is kept, its activations are recomputed in
    # the backward pass (train mode has no cache to write twice)
    remat = cfg.remat and ctx.mode == "train"
    sharded = any(isinstance(x, Blocks) for pg in params["groups"]
                  for x in pg.values())
    aux_total = 0.0
    for g in range(g0, g1):
        if remat:
            h, masses, probs = _remat(group, h, g, whole=sharded)
        else:
            h, masses, probs = group(h, g)
        aux_total = aux_total + keep(masses, probs)
    if tail:
        for i in range(cfg.n_tail):
            kind = cfg.layer_kinds[cfg.n_groups * len(pattern) + i]
            h, _st, rm, km, pr = apply_block(
                ctx, kind, params["tail"][i], h,
                cache["tail"][i] if want_cache else None)
            aux_total = aux_total + keep([(rm, km)],
                                         [] if pr is None else [pr])

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
    return h, new_cache, stats, kstats, aux_total


def forward(cfg: ModelConfig, params: Params, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            media: Optional[torch.Tensor] = None,
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
            logits_slice: str = "all",
            moe_tokens: Optional[int] = None,
            moe_probs: Optional[list] = None) -> ModelOutput:
    """``embeds`` [B,T,d] (musicgen's ``input_mode="embeds"``: frame
    embeddings from a stub frontend) replaces the token embedding;
    ``media`` [B,M,d] (the vision model's patch embeddings from a stub
    frontend) is what ``xattn`` layers attend to. ``moe_tokens`` and
    ``moe_probs``: ``Ctx.moe_tokens`` and ``run_stack``'s."""
    dtype = torch_dtype(cfg.dtype)
    h = _embed_inputs(cfg, params, tokens, embeds)
    if h.dim() == 2:
        h = h[:, None]
    B, T = h.shape[:2]
    if positions is None:
        # a tensor of its own: the kernel wrappers take contiguous rows
        positions = torch.arange(T, dtype=torch.int32,
                                 device=h.device).expand(B, T).contiguous()
    ctx = Ctx(cfg=cfg, mode=mode, positions=positions,
              media=None if media is None else media.to(dtype),
              chunk_ids=chunk_ids, collect_stats=collect_stats,
              attn_impl=attn_impl, decode_slot=decode_slot,
              slots=slots, seg_ids=seg_ids, kv_seg=kv_seg,
              paged_rows=paged_rows, paged_block_rows=paged_block_rows,
              paged_block_size=paged_block_size, moe_tokens=moe_tokens)
    h, new_cache, stats, kstats, aux_total = run_stack(
        cfg, params, h, ctx, cache=cache, collect_stats=collect_stats,
        moe_probs=moe_probs)
    if logits_slice == "last":
        h = h[:, -1:]
    # the vocab-split logits of every position stay with the train step's
    # loss; the last position's are gathered, as the serving steps return
    logits = None if isinstance(params["unembed"], Blocks) and \
        logits_slice != "last" else lm_head(cfg, params, h)
    return ModelOutput(logits=logits, cache=new_cache, stats=stats,
                       key_stats=kstats, aux_loss=aux_total, hidden=h)


def _embed_inputs(cfg: ModelConfig, params: Params, tokens, embeds):
    if embeds is None:
        return embed_tokens(cfg, params, tokens)
    return embeds.to(torch_dtype(cfg.dtype))


def _shard_layers(cfg: ModelConfig, params: List[Params],
                  caches: Optional[List[dict]] = None) -> list:
    """The stack's layers in order, each (kind, every data shard's
    leaves, every shard's cache of the layer or None, whether it sits in
    a layer group): the stacked group leaves unbound once per leaf."""
    unbound = [[{k: v.unbind() if isinstance(v, Blocks) else v.unbind(0)
                 for k, v in pg.items()} for pg in p["groups"]]
               for p in params]
    none = [None] * len(params)
    layers = []
    for g in range(cfg.n_groups):
        for pi, kind in enumerate(cfg.pattern):
            layers.append((kind, [{k: v[g] for k, v in u[pi].items()}
                                  for u in unbound],
                           none if caches is None else
                           [{k: v[g] for k, v in c["groups"][pi].items()}
                            for c in caches], True))
    for i in range(cfg.n_tail):
        kind = cfg.layer_kinds[cfg.n_groups * len(cfg.pattern) + i]
        layers.append((kind, [p["tail"][i] for p in params],
                       none if caches is None else
                       [c["tail"][i] for c in caches], False))
    return layers


def run_stack_lockstep(cfg: ModelConfig, params: List[Params],
                       inputs: List[dict], moe_tokens: int,
                       sync: Callable, scope: Callable = None):
    """The train-mode forward of the data shards of one microbatch of a
    config with experts, up to the final hidden states. ``params`` and
    ``inputs`` (``tokens`` or ``embeds``, and ``media``) per shard. The
    shards run layer by layer in shard order: at each MoE layer every
    shard routes its tokens, then ``sync`` (the expert ids [Gs, gs, k] of
    every shard -> each shard's ``(slot, kept)``) dispatches them over
    the global microbatch's groups (``moe_tokens`` tokens), then every
    shard runs its experts. Remat (``cfg.remat``) checkpoints each half
    of a group's layers, around the dispatch. ``scope(d)`` is entered
    around shard d's work. Returns (the shards' final hidden states, per
    shard the router probs of each MoE layer)."""
    n = len(params)
    scope = scope or (lambda d: contextlib.nullcontext())
    hs, ctxs = [], []
    for d, (p, x) in enumerate(zip(params, inputs)):
        with scope(d):
            h = _embed_inputs(cfg, p, x.get("tokens"), x.get("embeds"))
        B, T = h.shape[:2]
        media = x.get("media")
        hs.append(h)
        ctxs.append(Ctx(cfg=cfg, mode="train", positions=torch.arange(
            T, dtype=torch.int32, device=h.device).expand(B, T),
            media=None if media is None else media.to(h.dtype),
            moe_tokens=moe_tokens))
    layers = [(kind, ps, grouped)
              for kind, ps, _, grouped in _shard_layers(cfg, params)]

    def pre(ctx, kind, p, h):
        p = _whole(p)
        h = _mixer(ctx, kind, p, h, None)[0]
        return (h,) + _moe_route(ctx, p, h)

    def whole_block(ctx, kind, p, h):
        return apply_block(ctx, kind, p, h, None)[0]

    probs = [[] for _ in range(n)]
    for kind, ps, grouped in layers:
        run = _remat if cfg.remat and grouped else (lambda f, *a: f(*a))
        if kind == "ssd":
            for d in range(n):
                with scope(d):
                    hs[d] = run(whole_block, ctxs[d], kind, ps[d], hs[d])
            continue
        routed = []
        for d in range(n):
            with scope(d):
                routed.append(run(pre, ctxs[d], kind, ps[d], hs[d]))
        plans = sync([r[4] for r in routed])
        for d, ((h, xg, pr, gv, gi), (slot, kept)) in enumerate(
                zip(routed, plans)):
            probs[d].append(pr)
            with scope(d):
                hs[d] = run(_moe_apply, ctxs[d], kind, ps[d], h, xg, gv, gi,
                            slot, kept)
    return hs, probs


def forward_shards(cfg: ModelConfig, params: List[Params],
                   inputs: List[dict], caches: List[dict], *, mode: str,
                   attn_impl: str = "auto", moe_tokens: Optional[int] = None,
                   sync: Optional[Callable] = None,
                   scope: Callable = None) -> List[torch.Tensor]:
    """The serving forward (``mode`` prefill, partial or decode) of a
    mesh's data shards, each on its rows, returning each shard's
    last-position logits. ``params`` per shard, with ``sharding.Blocks``
    for the leaves split over the model axis; ``inputs`` per shard:
    ``tokens`` or ``embeds`` [B,T], ``positions`` [B,T] (optional in
    prefill), ``media``, and in decode ``decode_slot`` [B]; ``caches`` per
    shard, shaped like ``init_cache``'s, with ``sharding.Tiles`` leaves.
    The shards run layer by layer in shard order; at a MoE layer every
    shard routes its tokens first, ``sync`` (the expert ids of every
    shard -> each shard's ``(slot, kept)``) dispatches them over the
    GShard groups of all ``moe_tokens`` tokens, then every shard runs its
    experts, so that a group that spans shards fills its capacity across
    them, as in the unsharded forward. ``scope(d)`` is entered around
    shard d's work."""
    scope = scope or (lambda d: contextlib.nullcontext())
    dtype = torch_dtype(cfg.dtype)
    n = len(params)
    hs, ctxs = [], []
    for d, (p, x) in enumerate(zip(params, inputs)):
        with scope(d):
            h = _embed_inputs(cfg, p, x.get("tokens"), x.get("embeds"))
        B, T = h.shape[:2]
        pos = x.get("positions")
        if pos is None:
            pos = torch.arange(T, dtype=torch.int32,
                               device=h.device).expand(B, T).contiguous()
        media = x.get("media")
        hs.append(h)
        ctxs.append(Ctx(cfg=cfg, mode=mode, positions=pos,
                        media=None if media is None else media.to(dtype),
                        attn_impl=attn_impl,
                        decode_slot=x.get("decode_slot"),
                        moe_tokens=moe_tokens))
    for kind, ps, sts, _ in _shard_layers(cfg, params, caches):
        if kind == "ssd" or not cfg.num_experts or sync is None:
            for d in range(n):
                with scope(d):
                    hs[d] = apply_block(ctxs[d], kind, ps[d], hs[d],
                                        sts[d])[0]
            continue
        routed = []
        for d in range(n):
            with scope(d):
                p = _whole(ps[d])
                h = _mixer(ctxs[d], kind, p, hs[d], sts[d])[0]
                routed.append((p, h) + _moe_route(ctxs[d], p, h))
        plans = sync([r[5] for r in routed])
        for d, ((p, h, xg, _pr, gv, gi), (slot, kept)) in enumerate(
                zip(routed, plans)):
            with scope(d):
                hs[d] = _moe_apply(ctxs[d], kind, p, h, xg, gv, gi, slot,
                                   kept)
    logits = []
    for d in range(n):
        with scope(d):
            logits.append(lm_head(cfg, params[d], hs[d][:, -1:]))
    return logits


# Convenience entry points ---------------------------------------------------
def prefill(cfg, params, tokens=None, positions=None, chunk_ids=None,
            collect_stats=False, attn_impl="auto",
            cache_len: Optional[int] = None, embeds=None,
            ring: bool = True, media=None):
    """Full prefill into a fresh cache of ``cache_len`` (default T) slots;
    ``ring`` as in ``init_cache``."""
    B, T = (tokens if tokens is not None else embeds).shape[:2]
    cache = init_cache(cfg, B, cache_len or T,
                       device=params_device(params), ring=ring)
    return forward(cfg, params, tokens=tokens, embeds=embeds, media=media,
                   positions=positions, mode="prefill", cache=cache,
                   chunk_ids=chunk_ids, collect_stats=collect_stats,
                   attn_impl=attn_impl)


def partial_prefill(cfg, params, tokens, positions, cache, chunk_ids=None,
                    collect_stats=False, attn_impl="auto", embeds=None,
                    media=None):
    return forward(cfg, params, tokens=tokens, embeds=embeds, media=media,
                   positions=positions, mode="partial", cache=cache,
                   chunk_ids=chunk_ids, collect_stats=collect_stats,
                   attn_impl=attn_impl)


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

"""Cache-Craft partial-prefill executor (§3.4), in PyTorch: plan ->
assemble cached KV -> windowed layer execution with focused-chunk early
termination -> metadata capture -> store updates.

The layer stack runs in windows of ``focus_w`` layers (the Algorithm 1
confidence window): after each window the question->chunk attention
feeds the FocusTracker and, once the focused set is stable, the
recompute rows of unfocused hit-chunks leave the active set for the
remaining layers. Active-token and layout lengths are padded to a bucket
exactly as in the reference: PyTorch needs no jit cache, but the buckets
fix the padded shapes, and with them the sums the tests compare.

Host/device split: plans, the injected chunk KV and the results live on
the host as numpy (the store and the pool are host structures); the
model's cache, hidden states and parameters live on the executor's
device. Caches are updated in place (the reference donates them). The
RPE transform of stored chunk KV (re-rope on inject, de-rope before
storing) runs on the executor's device: the ``rope`` kernel on the card,
the plain ``apply_rope`` on the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import scoring
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.focus import FocusTracker
from repro_torch.core.planner import InferencePlan, build_plan, layout_plan
from repro_torch.core.preload import LayerStream, layerwise_schedule
from repro_torch.core.strategies import SelectScores, get_strategy
from repro_torch.core.tiers import CPU_TO_HBM_GBPS, SSD_GBPS, \
    merge_load_infos
from repro_torch.kernels.rope import ops as rope_ops
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope


def _bucket(n: int, b: int) -> int:
    return max(b, -(-n // b) * b)


def check_bf16_route(cfg: ModelConfig, attn_impl: Optional[str],
                     paged_decode: bool = False, *,
                     who: str = "CacheCraftExecutor"):
    """Raise ``ValueError`` for a model that is not fp32 on any route but
    ``kernel`` without paged decode. The caches the executor, the decode
    arena and the pool hold are fp32, and every other route returns fp32
    attention into the bf16 residual: the reference's executor and engine
    fail there in bf16 (ROADMAP C12). ``who`` names the caller."""
    if cfg.dtype == "float32" or (attn_impl == "kernel"
                                  and not paged_decode):
        return
    route = "the default (dense prefill, auto decode)" \
        if attn_impl is None else repr(attn_impl)
    if paged_decode:
        route += " with paged_decode"
    raise ValueError(
        f"{who}: a {cfg.dtype} model is served on attn_impl='kernel' "
        f"without paged_decode only, not on route {route}: the reference "
        "fails there in bf16 (fp32 attention into the bf16 residual; "
        "ROADMAP C12)")


def rope_np(cfg: ModelConfig, k, pos, *, device,
            inverse: bool = False) -> np.ndarray:
    """RoPE over host K ``[L, n, Hkv, D]`` at positions ``pos [n]`` (the
    same for every layer), computed on ``device``: on the host with the
    plain ``apply_rope``; on the card by the ``rope`` kernel (upload,
    one launch over all layers, download). Returns fp32 numpy."""
    device = torch.device(device)
    if device.type == "cpu":
        return apply_rope(torch.from_numpy(np.array(k, np.float32)),
                          torch.from_numpy(np.asarray(pos)),
                          cfg.rope_theta, inverse=inverse).numpy()
    return rope_ops.rope(
        _t(np.asarray(k, np.float32), device),
        _t(np.asarray(pos, np.int32), device), theta=cfg.rope_theta,
        inverse=inverse).cpu().numpy()


def inject_chunk_kv(cfg: ModelConfig, kv, rope_pos, *,
                    device) -> Tuple[np.ndarray, np.ndarray]:
    """Stored (de-roped) chunk-cache KV -> the exact bytes injected into
    a prefill layout at ``rope_pos``: float32 cast + RoPE at the target
    positions, on ``device`` (``rope_np``). Single source of truth shared
    by the executor's compute injection and the engine's canonical
    pool-run materialization: the zero-copy design's bit-equality
    REQUIRES both to produce identical bytes, so never fork this
    transform, and give both the same device."""
    return rope_np(cfg, kv["k"], rope_pos, device=device), \
        np.asarray(kv["v"], np.float32)


def _t(x, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def decode_fn(cfg, attn_impl="auto"):
    """One-token decode over the arena cache (engine + benches). ``slots``
    (the cache write index) is separate from ``positions`` (the
    RoPE/causality position).

    Row masking (incremental decode batch): a batch row with no live
    request passes ``positions[i] == -1`` and ``slots[i] == -1``; the KV
    write for that row is dropped, the position mask zeroes all of its
    attention, and its logits are finite and unread. The cache is
    updated in place."""
    def fn(params, tokens, positions, cache, slots=None):
        out = M.decode_step(cfg, params, tokens, positions, cache,
                            decode_slot=slots, attn_impl=attn_impl)
        return out.logits, cache
    return fn


def paged_decode_fn(cfg, attn_impl="paged", block_size=0):
    """One-token decode over the POOL-TWIN cache (leaves ``{"kp": [NBf,
    Hkv,D], "vp", "ppos": [NBf]}`` shared by every request; see the paged
    attend contract in models/backend.py).

    ``slots`` are pool-FLAT append slots (pre-opened host-side by
    ``KVPool.ensure_append_slot``; -1 = masked row). ``rows [B, S]`` are
    the compact slot-index rows of the *existing* tokens; the appended
    token's slot is spliced in at column ``positions`` so attention sees
    it the same step it is written, exactly like the arena path. The twin
    is updated in place (the reference donates it: it is the whole pool
    and must not double)."""
    def fn(params, tokens, positions, cache, slots, rows, block_rows=None):
        live = torch.nonzero(slots >= 0).squeeze(1)
        rows = rows.clone()
        rows[live, positions[live].long()] = slots[live]
        out = M.decode_step(cfg, params, tokens, positions, cache,
                            decode_slot=slots, attn_impl=attn_impl,
                            paged_rows=rows, paged_block_rows=block_rows,
                            paged_block_size=block_size)
        return out.logits, cache
    return fn


def paged_sync_fn(cfg):
    """Dirty-block upload into the pool-twin cache: host-side pool writes
    (prefill write-back, CoW clones, recompute fixups) land on the device
    twin as one scatter of the touched blocks' slots. ``slots [m]`` flat
    slot ids (-1 entries drop), ``k_upd/v_upd [L, m, Hkv, D]``, ``pos_upd
    [m]``. The twin is written in place (the reference donates it)."""
    P, G = len(cfg.pattern), cfg.n_groups

    def fn(cache, slots, k_upd, v_upd, pos_upd):
        live = torch.nonzero(slots >= 0).squeeze(1)
        ws = slots[live].long()
        if G:
            kg = k_upd[:G * P].reshape(G, P, *k_upd.shape[1:])
            vg = v_upd[:G * P].reshape(G, P, *v_upd.shape[1:])
            for p in range(P):
                c = cache["groups"][p]
                c["kp"][:, ws] = kg[:, p][:, live]
                c["vp"][:, ws] = vg[:, p][:, live]
                c["ppos"][:, ws] = pos_upd[live]
        for i in range(cfg.n_tail):
            c = cache["tail"][i]
            li = G * P + i
            c["kp"][ws] = k_upd[li][live]
            c["vp"][ws] = v_upd[li][live]
            c["ppos"][ws] = pos_upd[live]
        return cache
    return fn


# ---------------------------------------------------------------------------
# cache packing: engine-side per-layer numpy KV <-> model stacked cache
# ---------------------------------------------------------------------------
def pack_cache(cfg: ModelConfig, k_np, v_np, pos_np, device):
    """k/v [L,S,Hkv,D] numpy, pos [S] -> model cache (B=1) on ``device``."""
    P, G = len(cfg.pattern), cfg.n_groups
    k = _t(np.asarray(k_np, np.float32), device)
    v = _t(np.asarray(v_np, np.float32), device)
    pos = _t(np.asarray(pos_np, np.int32), device)
    S = k.shape[1]
    groups = []
    if G:
        kg = k[:G * P].reshape(G, P, *k.shape[1:])
        vg = v[:G * P].reshape(G, P, *v.shape[1:])
        for p in range(P):
            groups.append({
                "k": kg[:, p][:, None].contiguous(),   # [G, 1, S, Hkv, D]
                "v": vg[:, p][:, None].contiguous(),
                "pos": pos.expand(G, 1, S).clone(),
            })
    tail = []
    for i in range(cfg.n_tail):
        li = G * P + i
        tail.append({"k": k[li][None].clone(), "v": v[li][None].clone(),
                     "pos": pos[None].clone()})
    return {"groups": groups, "tail": tail}


def pack_paged_cache(cfg: ModelConfig, k_pool, v_pool, pos_pool, *,
                     device):
    """Pool block arenas (``KVPool.block_view()``: k/v [L, NB, bs, Hkv,
    D], pos [NB, bs]) -> the pool-twin decode cache with flat leaves
    ``{"kp": [NBf, Hkv, D], "vp", "ppos": [NBf]}`` per layer (grouped
    [G, ...] along the scan axis) on ``device``. One wholesale upload at
    paged-decode start; ``paged_sync_fn`` keeps it coherent after."""
    P, G = len(cfg.pattern), cfg.n_groups
    k = np.asarray(k_pool)
    v = np.asarray(v_pool)
    L = k.shape[0]
    kf = _t(k.reshape(L, -1, *k.shape[3:]), device)      # [L, NBf, Hkv, D]
    vf = _t(v.reshape(L, -1, *v.shape[3:]), device)
    pos = _t(np.asarray(pos_pool).reshape(-1).astype(np.int32), device)
    groups = []
    if G:
        kg = kf[:G * P].reshape(G, P, *kf.shape[1:])
        vg = vf[:G * P].reshape(G, P, *vf.shape[1:])
        for p in range(P):
            groups.append({
                "kp": kg[:, p].contiguous(),              # [G, NBf, Hkv, D]
                "vp": vg[:, p].contiguous(),
                "ppos": pos.expand(G, pos.shape[0]).clone(),
            })
    tail = []
    for i in range(cfg.n_tail):
        li = G * P + i
        tail.append({"kp": kf[li].clone(), "vp": vf[li].clone(),
                     "ppos": pos.clone()})
    return {"groups": groups, "tail": tail}


def unpack_cache(cfg: ModelConfig, cache) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Model cache (B=1) -> (k [L,S,Hkv,D], v, pos [S]) numpy arrays."""
    P, G = len(cfg.pattern), cfg.n_groups
    ks, vs = [], []
    pos = None
    if G:
        stacked_k = [cache["groups"][p]["k"][:, 0].cpu().numpy()
                     for p in range(P)]           # each [G, S, Hkv, D]
        stacked_v = [cache["groups"][p]["v"][:, 0].cpu().numpy()
                     for p in range(P)]
        pos = cache["groups"][0]["pos"][0, 0].cpu().numpy()
        for g in range(G):
            for p in range(P):
                ks.append(stacked_k[p][g])
                vs.append(stacked_v[p][g])
    for i in range(cfg.n_tail):
        ks.append(cache["tail"][i]["k"][0].cpu().numpy())
        vs.append(cache["tail"][i]["v"][0].cpu().numpy())
        if pos is None:
            pos = cache["tail"][i]["pos"][0].cpu().numpy()
    return np.stack(ks), np.stack(vs), pos


# ---------------------------------------------------------------------------
@dataclass
class StreamJob:
    """One hit decision whose KV is streamed layer by layer instead of
    being injected eagerly (``CacheCraftExecutor(layerwise_load=True)``)."""
    r: int                              # request index in the packed pass
    stream: LayerStream
    off: int                            # request's layout offset
    seg: object                         # the hit segment
    rope_pos: np.ndarray                # target RoPE positions


@dataclass
class PrefillResult:
    plan: InferencePlan
    logits_last: np.ndarray             # [V] logits of the final token
    k_layers: np.ndarray                # [L,S,Hkv,D] merged KV (roped)
    v_layers: np.ndarray
    pos_layout: np.ndarray              # [S]
    total_len: int
    active_rows_layers: int             # sum over layers of live rows
    focus_cutoff: Optional[int] = None
    focused: Optional[set] = None
    load_seconds_modeled: float = 0.0
    load_seconds_measured: float = 0.0
    tier_hits: Dict[str, int] = field(default_factory=dict)
    wall_seconds: float = 0.0
    # --- layer-granular streamed loads (layerwise_load=True) ---
    streamed: bool = False              # loads were streamed, not eager
    load_exposed_measured: float = 0.0  # wall time blocked at await points
    load_span_measured: float = 0.0     # wall span first request->last load
    load_blocked_layers: int = 0        # layer awaits that actually waited
    load_hidden_layers: int = 0         # layer loads fully hidden by compute
    preload_depth_used: int = 0         # Eq. 16 depth the pass ran with
    # trace for overlap assertions: {"windows": [(l0, l1, t_start)],
    #  "streams": [per-stream (event, layer, t) lists]}
    load_trace: Optional[dict] = None

    @property
    def compute_fraction(self) -> float:
        """Attention-layer token-rows actually computed vs full prefill."""
        L = self.k_layers.shape[0]
        return self.active_rows_layers / max(1, self.total_len * L)


class CacheCraftExecutor:
    """Binds (model config, params, chunk store) into a serving-side
    prefill engine on ``device`` (``params`` must live there).
    ``strategy``: any name registered in ``core.strategies.STRATEGIES``
    (resolved at construction, so an unknown name fails fast)."""

    def __init__(self, cfg: ModelConfig, params, store: Optional[ChunkStore],
                 *, strategy: str = "cachecraft", use_focus: bool = True,
                 focus_w: int = 3, bucket: int = 32,
                 fix_rpe: bool = True, fix_causality: bool = True,
                 store_fixed_variants: bool = True,
                 store_new_chunks: bool = True,
                 force_recompute_fraction: Optional[float] = None,
                 layerwise_load: bool = False,
                 attn_impl: str = "dense",
                 rng: Optional[np.random.Generator] = None,
                 device="cuda"):
        if not cfg.supports_chunk_cache and store is not None:
            raise ValueError(
                f"{cfg.name}: chunk-cache inapplicable (see DESIGN.md §6)")
        check_bf16_route(cfg, attn_impl)
        self.device = devmod.resolve(device)
        if M.params_device(params) != self.device:
            raise ValueError(
                f"params live on {M.params_device(params)}, executor "
                f"device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.store = store
        self.strategy = strategy
        self.strategy_obj = get_strategy(strategy)
        self.use_focus = use_focus
        self.focus_w = focus_w
        self.bucket = bucket
        self.fix_rpe = fix_rpe
        self.fix_causality = fix_causality
        self.store_fixed_variants = store_fixed_variants
        self.store_new_chunks = store_new_chunks
        self.force_recompute_fraction = force_recompute_fraction
        # layer-granular streamed tier loads (Eq. 16 / Algorithm 2): hit
        # KV arrives per layer right before the window that computes it
        self.layerwise_load = layerwise_load and store is not None
        # attention backend of the windowed partial prefill (a name in
        # models.backend.BACKENDS; "dense" is the oracle)
        self.attn_impl = attn_impl
        # EMA of measured per-layer window compute (feeds Eq. 16)
        self._t_layer_s = 0.0
        self.rng = rng or np.random.default_rng(0)

    def _window(self, h, positions, chunk_ids, cache, slots, seg_ids,
                kv_seg, pack_qidx, pack_kidx, g0, g1, tail, collect):
        ctx = M.Ctx(cfg=self.cfg, mode="partial", positions=positions,
                    chunk_ids=chunk_ids, collect_stats=collect,
                    attn_impl=self.attn_impl, slots=slots, seg_ids=seg_ids,
                    kv_seg=kv_seg, pack_qidx=pack_qidx, pack_kidx=pack_kidx)
        return M.run_stack(self.cfg, self.params, h, ctx, cache=cache,
                           collect_stats=collect, g0=g0, g1=g1, tail=tail)

    def _dev(self, x, dtype=None):
        return _t(x, self.device, dtype)

    # ---- main entry --------------------------------------------------------
    def process(self, system_tokens, chunks: Sequence[np.ndarray],
                question_tokens, collect_stats: bool = True
                ) -> PrefillResult:
        """Single-request convenience wrapper over ``process_batch``."""
        return self.process_batch(
            [(system_tokens, chunks, question_tokens)],
            collect_stats=collect_stats)[0]

    @torch.no_grad()
    def process_batch(self, requests: Sequence[tuple],
                      collect_stats: bool = True) -> List[PrefillResult]:
        """Packed multi-request partial prefill.

        ``requests`` is a sequence of (system_tokens, chunk_tokens,
        question_tokens) triples. All requests' recompute tokens execute
        as ONE shape-bucketed windowed pass: request ``r``'s prompt
        occupies layout slots ``[off_r, off_r + total_len_r)`` of the
        packed KV, every token keeps its request-local RoPE position, and
        a per-token segment id threaded through the attention mask keeps
        attention within the request. Focus-tracker early termination
        (Algorithm 1) runs per request within the packed batch. Returns
        one PrefillResult per request, in input order."""
        if not requests:
            return []
        cfg = self.cfg
        dev = self.device
        t_start = time.perf_counter()
        plans = [build_plan(
            self.store if self.strategy_obj.needs_store else None,
            sys_t, chs, q_t, strategy=self.strategy_obj, rng=self.rng,
            force_recompute_fraction=self.force_recompute_fraction)
            for sys_t, chs, q_t in requests]
        if self.strategy_obj.needs_deviation:
            plans = [self._finalize_deviation_plan(p) for p in plans]
        R = len(plans)

        L = cfg.num_layers
        hkv, dh = cfg.num_kv_heads, cfg.head_dim_
        offs = np.concatenate(
            [[0], np.cumsum([p.total_len for p in plans])]).astype(np.int64)
        # the totals bucket coarsens under packing so the padded shapes
        # stay few when many request combinations get packed together
        tot_bucket = self.bucket if R == 1 else \
            max(8 * self.bucket, self.bucket * R)
        blk_bucket = self.bucket if R == 1 else 2 * self.bucket
        S = _bucket(int(offs[-1]), tot_bucket)
        k_np = np.zeros((L, S, hkv, dh), np.float32)
        v_np = np.zeros((L, S, hkv, dh), np.float32)
        pos_layout = np.full(S, -1, np.int32)
        seg_layout = np.full(S, -1, np.int32)
        layout_sid = np.full(S, cfg.stats_chunks - 1, np.int32)

        # --- inject cached chunk KV (RoPE re-applied at local positions) ---
        load_modeled = np.zeros(R)
        load_measured = np.zeros(R)
        tier_hits: List[Dict[str, int]] = [
            {"hbm": 0, "cpu": 0, "ssd": 0} for _ in range(R)]
        stream_jobs: List[StreamJob] = []
        for r, plan in enumerate(plans):
            off = int(offs[r])
            for d in plan.decisions:
                if not d.is_hit:
                    continue
                span = np.arange(d.seg.start, d.seg.end, dtype=np.int32)
                rope_pos = span if self.fix_rpe else \
                    (np.arange(d.seg.length) + d.variant.scores.orig_start)
                pos_layout[off + d.seg.start:off + d.seg.end] = \
                    span if self.fix_causality \
                    else (np.arange(d.seg.length) +
                          d.variant.scores.orig_start)
                self.store.record_use(d.variant, max(d.cfo, 1e-3))
                if self.layerwise_load and d.variant.num_layers == L:
                    stream_jobs.append(StreamJob(
                        r=r, stream=LayerStream(self.store, d.variant),
                        off=off, seg=d.seg, rope_pos=rope_pos))
                    continue
                kv, info = self.store.get_kv(d.variant)
                if info is not None:
                    load_modeled[r] += info.seconds_modeled
                    load_measured[r] += info.seconds_measured
                    tier_hits[r][info.tier] += 1
                kc, vc = inject_chunk_kv(cfg, kv, rope_pos, device=dev)
                k_np[:, off + d.seg.start:off + d.seg.end] = kc
                v_np[:, off + d.seg.start:off + d.seg.end] = vc
            # key-side (layout) stat ids for the model's mass statistic
            for seg in plan.segments:
                layout_sid[off + seg.start:off + seg.end] = seg.stat_id
            seg_layout[off:off + plan.total_len] = r

        # Eq. 16 / Algorithm 2: size the preload depth from measured
        # per-layer compute vs estimated per-layer load cost, then kick
        # off the first lp layers in the background
        schedule = None
        trace_windows: List[tuple] = []
        if stream_jobs:
            t_load_layer = sum(self._layer_load_estimate(j.stream.var)
                               for j in stream_jobs)
            schedule = layerwise_schedule(L, self._t_layer_s, t_load_layer)
            for l in range(min(L, schedule.depth)):
                for job in stream_jobs:
                    job.stream.request([l])
        layout_sid_t = self._dev(layout_sid[None])
        kv_seg_t = self._dev(seg_layout[None])

        # --- active rows (padded to bucket; row_map -> packed index) -------
        n_acts = [p.num_active_tokens for p in plans]
        act_offs = np.concatenate([[0], np.cumsum(n_acts)]).astype(np.int64)
        n_act_total = int(act_offs[-1])
        A = _bucket(n_act_total, tot_bucket)
        act_tok = np.zeros(A, np.int32)
        act_pos = np.full(A, -1, np.int32)
        act_slot = np.full(A, -1, np.int32)
        act_seg = np.full(A, -1, np.int32)
        act_sid = np.full(A, cfg.stats_chunks - 1, np.int32)
        row_map = np.full(A, -1, np.int64)
        for r, plan in enumerate(plans):
            a0, a1 = int(act_offs[r]), int(act_offs[r + 1])
            act_tok[a0:a1] = plan.active_tokens
            act_pos[a0:a1] = plan.active_positions
            act_slot[a0:a1] = plan.active_positions + int(offs[r])
            act_seg[a0:a1] = r
            act_sid[a0:a1] = plan.active_stat_ids
            row_map[a0:a1] = np.arange(a0, a1)

        hit_ids = [{d.seg.stat_id for d in p.decisions
                    if d.is_hit and len(d.recompute_idx) > 0}
                   for p in plans]
        trackers = [FocusTracker(len(plans[r].decisions), w=self.focus_w)
                    if (self.use_focus and hit_ids[r] - {0}) else None
                    for r in range(R)]
        P, G = len(cfg.pattern), cfg.n_groups
        w_groups = max(1, -(-self.focus_w // P)) \
            if any(t is not None for t in trackers) else max(1, G)
        if stream_jobs:
            # every window boundary is an await point: one layer group
            # per window lets later layers keep loading (Algorithm 2)
            w_groups = 1

        h = M.embed_tokens(cfg, self.params, self._dev(act_tok[None]))
        pos_np = act_pos.copy()
        slot_np = act_slot.copy()
        positions = self._dev(pos_np[None])
        slots = self._dev(slot_np[None])
        seg_ids = self._dev(act_seg[None])
        sid_np = act_sid.copy()
        seg_np = act_seg.copy()

        # block-diagonal gather maps: per-request query rows (recomputed
        # after focus drops) and KV slots (static layout), so dense
        # attention runs on [R, Amax] x [R, Smax] blocks
        def _qidx_map():
            if R == 1:
                return None
            rows = [np.where(seg_np == r)[0] for r in range(R)]
            amax = _bucket(max(max(len(x) for x in rows), 1), blk_bucket)
            out = np.full((R, amax), -1, np.int64)
            for r, x in enumerate(rows):
                out[r, :len(x)] = x
            return self._dev(out)

        pack_qidx = _qidx_map()
        pack_kidx = None
        if R > 1:
            smax = _bucket(max(p.total_len for p in plans), blk_bucket)
            kidx = np.full((R, smax), -1, np.int64)
            for r, plan in enumerate(plans):
                kidx[r, :plan.total_len] = np.arange(
                    int(offs[r]), int(offs[r]) + plan.total_len)
            pack_kidx = self._dev(kidx)
        cache = pack_cache(cfg, k_np, v_np, pos_layout, dev)
        stats_all = np.zeros((L, n_act_total, cfg.stats_chunks), np.float32) \
            if collect_stats else None
        kstats_all = np.zeros((L, S), np.float32) if collect_stats else None
        rows_layers = np.zeros(R, np.int64)
        focus_cutoff: List[Optional[int]] = [None] * R
        focused: List[Optional[set]] = [None] * R
        chunk_stat_ids = [list(range(1, len(p.decisions))) for p in plans]

        # window starts: groups in steps of w_groups, then the tail
        starts = list(range(0, G, w_groups)) or [0]
        layer_idx = 0
        t_compute = 0.0
        for wi, g0 in enumerate(starts):
            g1 = min(G, g0 + w_groups)
            is_last = wi == len(starts) - 1
            nl = (g1 - g0) * P + (cfg.n_tail if is_last else 0)
            if stream_jobs:
                self._stage_window_layers(
                    stream_jobs, schedule, cache, k_np, v_np,
                    range(layer_idx, layer_idx + nl), trace_windows)
            t_w0 = time.perf_counter()
            # the window writes its cache slices in place, so no
            # write-back of the returned window follows
            h, _win_cache, stats, kstats, _aux = self._window(
                h, positions, layout_sid_t, cache, slots, seg_ids,
                kv_seg_t, pack_qidx, pack_kidx, g0=g0, g1=g1,
                tail=is_last and cfg.n_tail > 0, collect=collect_stats)
            devmod.sync(dev)
            t_compute += time.perf_counter() - t_w0
            live_pos = pos_np >= 0
            for r in range(R):
                rows_layers[r] += int((live_pos & (seg_np == r)).sum()) * nl
            if collect_stats and stats is not None:
                st = stats[:, 0].cpu().numpy()            # [nl, A_cur, C]
                valid = row_map >= 0
                stats_all[layer_idx:layer_idx + nl][:, row_map[valid]] = \
                    st[:, valid]
                if kstats is not None and kstats.shape[-1] == S:
                    kstats_all[layer_idx:layer_idx + nl] += \
                        kstats[:, 0].cpu().numpy()
                # Algorithm 1 update from question-row mass, per request
                newly_converged = []
                for r, tracker in enumerate(trackers):
                    if tracker is None or tracker.converged:
                        continue
                    qrows = (sid_np == plans[r].question.stat_id) & \
                        (seg_np == r)
                    for li in range(st.shape[0]):
                        qi = st[li][qrows][:, chunk_stat_ids[r]].sum(0)
                        full_vec = np.zeros(len(plans[r].decisions))
                        full_vec[chunk_stat_ids[r]] = qi
                        if tracker.update(full_vec):
                            break
                    if tracker.converged:
                        focus_cutoff[r] = tracker.cutoff_layer
                        focused[r] = tracker.focused
                        newly_converged.append(r)
                if newly_converged and not is_last:
                    drop = np.zeros(sid_np.shape[0], bool)
                    for r in newly_converged:
                        unfocused = (hit_ids[r] - {0}) - set(focused[r])
                        if unfocused:
                            drop |= np.isin(sid_np, list(unfocused)) & \
                                (seg_np == r) & (pos_np >= 0) & \
                                (sid_np != plans[r].question.stat_id)
                    if drop.any() and R > 1:
                        # packed batch: mask dropped rows IN PLACE (pos /
                        # slot -> -1 makes them attention-inert padding
                        # with their KV writes dropped) so every tensor
                        # keeps its shape
                        pos_np = pos_np.copy()
                        slot_np = slot_np.copy()
                        pos_np[drop] = -1
                        slot_np[drop] = -1
                        sid_np = sid_np.copy()
                        sid_np[drop] = cfg.stats_chunks - 1
                        row_map = row_map.copy()
                        row_map[drop] = -1
                        positions = self._dev(pos_np[None])
                        slots = self._dev(slot_np[None])
                    elif drop.any():
                        # single request: re-bucket to a smaller active
                        # set, which saves real window compute
                        keep_idx = np.where(~drop & (row_map >= 0))[0]
                        A2 = _bucket(len(keep_idx), tot_bucket)
                        gather = np.zeros(A2, np.int64)
                        gather[:len(keep_idx)] = keep_idx
                        n_keep = len(keep_idx)
                        h = h[:, self._dev(gather)]
                        pos2 = pos_np[gather]
                        slot2 = slot_np[gather]
                        sid2 = sid_np[gather]
                        seg2 = seg_np[gather]
                        rm2 = row_map[gather]
                        pos2[n_keep:] = -1
                        slot2[n_keep:] = -1
                        sid2[n_keep:] = cfg.stats_chunks - 1
                        seg2[n_keep:] = -1
                        rm2[n_keep:] = -1
                        pos_np, slot_np = pos2, slot2
                        positions = self._dev(pos2[None])
                        slots = self._dev(slot2[None])
                        seg_ids = self._dev(seg2[None])
                        sid_np = sid2
                        seg_np = seg2
                        row_map = rm2
                        pack_qidx = _qidx_map()
            layer_idx += nl

        # measured per-layer compute feeds the next pass's Eq. 16 depth
        if L:
            t_layer = t_compute / L
            self._t_layer_s = t_layer if self._t_layer_s == 0.0 else \
                0.5 * self._t_layer_s + 0.5 * t_layer

        # streamed-load accounting (see the reference executor)
        exposed_measured = np.zeros(R)
        blocked_layers = np.zeros(R, np.int64)
        hidden_layers = np.zeros(R, np.int64)
        span_measured = np.zeros(R)
        stream_traces: List[List[list]] = [[] for _ in range(R)]
        req_infos: List[list] = [[] for _ in range(R)]
        for job in stream_jobs:
            s = job.stream
            info = merge_load_infos(s._infos)
            if info is not None:
                load_modeled[job.r] += info.seconds_modeled
                tier_hits[job.r][info.tier] += 1
            req_infos[job.r].extend(s._infos)
            exposed_measured[job.r] += s.blocked_seconds
            blocked_layers[job.r] += s.blocked_layers
            hidden_layers[job.r] += s.hidden_layers
            stream_traces[job.r].append(list(s.trace))
        for r, infos in enumerate(req_infos):
            # union of every layer load's [t0, t1) window of the request
            info = merge_load_infos(infos)
            if info is not None:
                load_measured[r] += info.seconds_measured
        for r in range(R):
            ts_all = [t for tr in stream_traces[r] for _ev, _l, t in tr]
            if ts_all:
                span_measured[r] = max(ts_all) - min(ts_all)

        # --- head: logits of each request's final question token -----------
        last_rows = [int(np.where(row_map == int(act_offs[r + 1]) - 1)[0][0])
                     for r in range(R)]
        logits = M.lm_head(cfg, self.params, h[:, self._dev(
            np.asarray(last_rows, np.int64))])
        logits_np = logits[0].float().cpu().numpy()     # [R, V]

        k_fin, v_fin, pos_fin = unpack_cache(cfg, cache)
        wall = time.perf_counter() - t_start
        results = []
        for r, plan in enumerate(plans):
            off, end = int(offs[r]), int(offs[r]) + plan.total_len
            k_r = k_fin[:, off:end]
            v_r = v_fin[:, off:end]
            p_r = pos_fin[off:end]
            if self.store is not None and collect_stats:
                st_r = stats_all[:, int(act_offs[r]):int(act_offs[r + 1])]
                ks_r = None if kstats_all is None else kstats_all[:, off:end]
                self._capture(plan, st_r, ks_r, k_r, v_r)
            streamed = any(j.r == r for j in stream_jobs)
            results.append(PrefillResult(
                plan=plan, logits_last=logits_np[r], k_layers=k_r,
                v_layers=v_r, pos_layout=p_r, total_len=plan.total_len,
                active_rows_layers=int(rows_layers[r]),
                focus_cutoff=focus_cutoff[r], focused=focused[r],
                load_seconds_modeled=float(load_modeled[r]),
                load_seconds_measured=float(load_measured[r]),
                tier_hits=tier_hits[r], wall_seconds=wall,
                streamed=streamed,
                load_exposed_measured=float(exposed_measured[r]),
                load_span_measured=float(span_measured[r]),
                load_blocked_layers=int(blocked_layers[r]),
                load_hidden_layers=int(hidden_layers[r]),
                preload_depth_used=schedule.depth if schedule else 0,
                load_trace={"windows": list(trace_windows),
                            "streams": stream_traces[r]}
                if streamed else None))
        return results

    # ---- CacheBlend deviation probe (strategy_obj.needs_deviation) --------
    @torch.no_grad()
    def _finalize_deviation_plan(self, plan: InferencePlan) -> InferencePlan:
        """Finalize deferred (deviation-probed) decisions: run the FIRST
        layer window of this request alone with EVERY token active (the
        scatter overwrites each injected cache slot before attention, so
        the window produces the full-recompute KV of the probe layers),
        then rank each hit chunk's tokens by squared KV deviation of the
        cached bytes vs the recomputed ones and let the strategy pick
        top-deviation tokens ANYWHERE in the chunk. Plans without deferred
        decisions pass through untouched; the finalized plan is
        re-laid-out via ``layout_plan``."""
        deferred = [d for d in plan.decisions if d.deferred]
        if not deferred:
            return plan
        cfg = self.cfg
        L = cfg.num_layers
        P, G = len(cfg.pattern), cfg.n_groups
        probe_layers = list(range(P)) if G else list(range(cfg.n_tail))
        hkv, dh = cfg.num_kv_heads, cfg.head_dim_
        T = plan.total_len
        S = _bucket(T, self.bucket)
        k_np = np.zeros((L, S, hkv, dh), np.float32)
        v_np = np.zeros((L, S, hkv, dh), np.float32)
        pos_layout = np.full(S, -1, np.int32)
        pos_layout[:T] = np.arange(T, dtype=np.int32)
        seg_layout = np.full(S, -1, np.int32)
        seg_layout[:T] = 0
        layout_sid = np.full(S, cfg.stats_chunks - 1, np.int32)
        for seg in plan.segments:
            layout_sid[seg.start:seg.end] = seg.stat_id
        cached_ref = {}
        for d in plan.decisions:
            if not d.is_hit:
                continue
            span = np.arange(d.seg.start, d.seg.end, dtype=np.int32)
            rope_pos = span if self.fix_rpe else \
                (np.arange(d.seg.length) + d.variant.scores.orig_start)
            # probe-only read: the main pass records the actual use
            kv, _info = self.store.get_kv(d.variant)
            kc, vc = inject_chunk_kv(cfg, kv, rope_pos, device=self.device)
            k_np[:, d.seg.start:d.seg.end] = kc
            v_np[:, d.seg.start:d.seg.end] = vc
            if d.deferred:
                cached_ref[id(d)] = (kc, vc)

        act_tok = np.zeros(S, np.int32)
        act_tok[:T] = np.concatenate(
            [s.tokens for s in plan.segments]).astype(np.int32)
        act_pos = self._dev(pos_layout[None])
        seg_t = self._dev(seg_layout[None])
        h = M.embed_tokens(cfg, self.params, self._dev(act_tok[None]))
        cache = pack_cache(cfg, k_np, v_np, pos_layout, self.device)
        _h, new_cache, _stats, _kstats, _aux = self._window(
            h, act_pos, self._dev(layout_sid[None]), cache, act_pos,
            seg_t, seg_t, None, None, g0=0, g1=min(G, 1), tail=G == 0,
            collect=False)

        for d in deferred:
            s0, s1 = d.seg.start, d.seg.end
            kc, vc = cached_ref[id(d)]
            dev = np.zeros(d.seg.length)
            for l in probe_layers:
                if G:
                    k_new = new_cache["groups"][l]["k"][0, 0, s0:s1]
                    v_new = new_cache["groups"][l]["v"][0, 0, s0:s1]
                else:
                    k_new = new_cache["tail"][l]["k"][0, s0:s1]
                    v_new = new_cache["tail"][l]["v"][0, s0:s1]
                k_new = k_new.cpu().numpy()
                v_new = v_new.cpu().numpy()
                dev += ((k_new - kc[l]) ** 2).sum(axis=(1, 2))
                dev += ((v_new - vc[l]) ** 2).sum(axis=(1, 2))
            frac = self.force_recompute_fraction \
                if self.force_recompute_fraction is not None else d.cfo
            d.recompute_idx = self.strategy_obj.select_tokens(
                SelectScores(deviation=dev), frac, self.rng)
            d.deferred = False
        return layout_plan(plan.segments[:-1], plan.decisions,
                           plan.question, plan.total_len)

    # ---- layer-granular streamed loads (Eq. 16 / Algorithm 2) -------------
    def _layer_load_estimate(self, var) -> float:
        """Modeled per-layer load cost for one streamed variant: bytes per
        layer (the tier store's STORED size when registered, else the
        variant's fp32 footprint) over the bandwidth of the tier its
        first layer slice sits in, plus any injected test latency."""
        tiers = self.store.tiers
        lkey = ChunkStore._lkey(var.variant_id, 0)
        where = tiers.where(lkey)
        if where in (None, "hbm"):
            return 0.0
        bw = CPU_TO_HBM_GBPS if where == "cpu" else SSD_GBPS
        per_layer = tiers.sizes.get(
            lkey, var.nbytes / max(1, var.num_layers))
        return per_layer / (bw * 1e9) + tiers.load_delay_s

    def _stage_window_layers(self, stream_jobs, schedule, cache,
                             k_np, v_np, win_layers, trace_windows):
        """Make the window's layers resident before it computes: issue the
        schedule's look-ahead requests, then await + inject exactly the
        window's layer slices into the packed KV and the cache entries the
        window will read. Await points are where load time becomes
        *exposed*."""
        cfg = self.cfg
        P, G = len(cfg.pattern), cfg.n_groups
        win_layers = list(win_layers)
        L = self.cfg.num_layers
        for l in range(min(L, win_layers[-1] + 1 + schedule.depth)):
            for job in stream_jobs:
                job.stream.request([l])
        trace_windows.append((win_layers[0], win_layers[-1] + 1,
                              time.monotonic()))
        for job in stream_jobs:
            s0 = job.off + job.seg.start
            s1 = job.off + job.seg.end
            for l in win_layers:
                kv_l, _info = job.stream.await_layer(l)
                if kv_l is None:
                    raise RuntimeError(
                        f"{job.stream.var.variant_id}: layer {l} KV "
                        "vanished from every tier mid-stream")
                # the SAME transform as the eager path / canonical pool
                # runs, applied to one layer (RoPE is layer-independent)
                kc, vc = inject_chunk_kv(
                    cfg, {"k": kv_l["k"][None], "v": kv_l["v"][None]},
                    job.rope_pos, device=self.device)
                k_np[l, s0:s1] = kc[0]
                v_np[l, s0:s1] = vc[0]
        # refresh the cache slices the window reads
        for l in win_layers:
            if l < G * P:
                g, p = divmod(l, P)
                cache["groups"][p]["k"][g].copy_(
                    torch.from_numpy(k_np[l])[None])
                cache["groups"][p]["v"][g].copy_(
                    torch.from_numpy(v_np[l])[None])
            else:
                ti = l - G * P
                cache["tail"][ti]["k"].copy_(torch.from_numpy(k_np[l])[None])
                cache["tail"][ti]["v"].copy_(torch.from_numpy(v_np[l])[None])

    # ---- metadata + store update -------------------------------------------
    def _capture(self, plan: InferencePlan, stats, kstats, k_fin, v_fin):
        """Create variants for miss chunks (and optionally 'fixed' hit
        chunks); stats [L, n_act, C] aligned to plan's active ordering."""
        cfg = self.cfg
        sid = plan.active_stat_ids
        pos = plan.active_positions
        lengths = [d.seg.length for d in plan.decisions]
        hashes = [d.seg.chash for d in plan.decisions]
        inter = scoring.inter_matrix(stats, sid.astype(np.int64),
                                     len(plan.decisions))
        for i, d in enumerate(plan.decisions):
            if d.is_hit:
                if not (self.store_fixed_variants and d.cfo >= 0.5):
                    continue
                if len(self.store.lookup(d.seg.chash)) >= \
                        self.store.m_variants:
                    continue
            elif not self.store_new_chunks:
                continue
            rows = sid == i
            if not rows.any():
                continue
            tok_inter = np.zeros(d.seg.length)
            ext = [c for c in range(len(plan.decisions) + 1) if c != i]
            row_pos = pos[rows] - d.seg.start
            vals = stats[:, rows][:, :, ext].sum((0, 2))
            ok = (row_pos >= 0) & (row_pos < d.seg.length)
            if d.is_hit and len(d.variant.scores.token_inter) == d.seg.length:
                tok_inter = d.variant.scores.token_inter.copy()
            tok_inter[row_pos[ok]] = vals[ok]
            tok_total = None
            if kstats is not None and kstats.shape[1] >= d.seg.end and \
                    kstats.sum() > 0:
                tok_total = kstats[:, d.seg.start:d.seg.end].sum(0)
            sc = scoring.chunk_scores(inter, lengths, i, hashes[:i],
                                      tok_inter, token_total=tok_total,
                                      orig_start=d.seg.start)
            # stored position-independent: RoPE removed (§4), on the
            # executor's device
            kv = {
                "k": rope_np(cfg, k_fin[:, d.seg.start:d.seg.end],
                             np.arange(d.seg.start, d.seg.end,
                                       dtype=np.int32),
                             device=self.device, inverse=True),
                "v": v_fin[:, d.seg.start:d.seg.end].copy(),
            }
            self.store.add_variant(d.seg.chash, kv, sc)

"""Chunk-cache store: N x M variants, reuse-frequency eviction (§3.3).

Each knowledge-base chunk (identified by a content hash tied to the RAG
retriever) maps to a list of cache *variants* — KV tensors captured under
different past prefixes, each with the metadata needed to score
reusability at lookup time (CCI, per-prefix inter weights, per-token
external attention for Eq. 14). Variant selection minimizes
CFO = CCI * (1 - beta'); every access bumps the variant's
reuse-frequency f_r += 1/CFO, and the lowest-scored variants are
evicted once the store exceeds N*M instances — the paper's argument for
why plain LRU/LFU/FIFO is insufficient.

Eviction-policy contract (cache-manager architecture): every eviction
site in the store shares one pluggable ``core.eviction.EvictionPolicy``
— variant capping (``_evict_if_needed``), pool-run reclaim ordering
(``reclaim_pool_runs``), and, through ``TieredStore.attach_stats``, the
tier demotion of this store's entries. The default
``ReuseAwarePolicy`` scores ``f_r x tokens / bytes``, which reduces
exactly to the historical lowest-``f_r`` capping rule (cost/size is a
constant ratio for chunk KV), while making tier demotion
reuse-frequency-aware instead of recency-only.

Layer-sliced tier storage (§3.4.2 / Eq. 16): variants are stored as one
tier entry per layer (``<vid>@L<nn>``), so the layer-wise preload
schedule can stream exactly the layers the executor is about to
compute (``core.preload.LayerStream``) instead of blocking on the whole
variant. ``get_kv`` reassembles the full [L, ...] view; tier pins on
the bare variant id cover every layer slice (group-aware pinning).
Layer slices ride the tier store's quantized representations
transparently (``core.tiers`` "Quantized tiers"): ``TieredStore.get``
returns dequantized fp32, while demoted slices occupy (and are
evicted by) their quantized STORED bytes. This is orthogonal to this
module's own opt-in ``quantize_kv`` path, which quantizes at capture
time into the variant payload itself (``k_q``/``k_s`` leaves — kept
raw by the tier codec's small-leaf pass-through).

Pool residency (zero-copy chunk sharing): ``attach_pool`` wires the
store to the serving ``KVPool``. The ``PoolResidency`` registry then
pins one canonical, block-aligned KV run per (variant, layout-start)
into pool blocks; requests reference those shared blocks instead of
copying the chunk KV per request. The store holds the run's owning pool
reference; variant eviction unpins immediately at zero readers and
defers the unpin to the last reader's release otherwise, and the
variant's tier entry stays pinned against demotion while pool-resident
(it is read by every hitting prefill's compute pass).
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.eviction import Candidate, EvictionPolicy, \
    ReuseAwarePolicy, get_policy
from repro_torch.core.scoring import ChunkScores, beta_prime, cfo as cfo_fn
from repro_torch.core.tiers import LoadInfo, PrefetchTicket, TieredStore, \
    merge_load_infos, tree_nbytes


def chunk_hash(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).hexdigest()[:16]


def prompt_hashes(system_tokens, chunks: Sequence[np.ndarray]) -> List[str]:
    """Canonical per-segment hash list for a [system][chunks...] prompt.

    Single source of truth shared by plan building, prefetch scheduling
    and the delta-reservation estimator — the latter probes pool
    residency by (variant, layout start), so a drifting copy of this
    logic would silently desynchronize admission estimates from the
    actual write-back."""
    return ["SYS-" + chunk_hash(np.asarray(system_tokens))] + \
        [chunk_hash(np.asarray(c)) for c in chunks]


@dataclass
class Variant:
    variant_id: str
    chunk_hash: str
    scores: ChunkScores
    num_tokens: int
    nbytes: int
    f_r: float = 0.0
    uses: int = 0
    num_layers: int = 0          # > 0: stored as per-layer tier slices
    last_access: float = 0.0     # store-access sequence (LRU candidates)


@dataclass
class SharedRun:
    """One canonical pool-resident KV run for (variant, layout start).

    ``blocks`` carry the store's owning reference (refcount 1 from the
    materializing ``alloc``); each reader adds one more via
    ``KVPool.append_shared``. ``readers`` counts requests currently
    referencing the run; ``evict_pending`` marks a variant eviction that
    arrived while readers were live — the unpin happens at the last
    ``release``."""
    key: Tuple[str, int]
    variant_id: str
    blocks: List[int]
    n_tokens: int
    readers: int = 0
    evict_pending: bool = False
    last_used: float = 0.0       # residency-clock sequence (LRU cands)


class PoolResidency:
    """Registry of pool-resident chunk-cache runs (pin/unpin lifecycle,
    see the ``kvpool`` module docstring)."""

    def __init__(self, pool):
        self.pool = pool
        self.runs: Dict[Tuple[str, int], SharedRun] = {}
        self._clock = itertools.count(1)

    def resident(self, variant_id: str, start: int) -> bool:
        return (variant_id, start) in self.runs

    def acquire(self, variant: "Variant", start: int,
                loader: Callable[[], Optional[tuple]],
                reservation=None) -> Optional[SharedRun]:
        """Return the canonical run for (variant, start) with one reader
        reference added, materializing it on first use. ``loader`` must
        yield the (k [L,S,..], v, pos [S]) exactly as the executor would
        inject them (roped at the layout span); returning None — e.g.
        the variant's KV is gone from every tier — aborts the pin and
        the caller falls back to the copy path."""
        key = (variant.variant_id, start)
        run = self.runs.get(key)
        if run is None:
            loaded = loader()
            if loaded is None:
                return None
            k, v, pos = loaded
            blocks = self.pool.alloc(self.pool.blocks_needed(k.shape[1]),
                                     reservation)
            if blocks is None:
                return None
            self.pool.write_run(blocks, k, v, pos)
            run = SharedRun(key=key, variant_id=variant.variant_id,
                            blocks=blocks, n_tokens=int(k.shape[1]))
            self.runs[key] = run
            self.pool.counters.shared_runs_materialized += 1
        run.readers += 1
        run.last_used = float(next(self._clock))
        return run

    def release(self, run: SharedRun):
        """Drop one reader reference; a deferred eviction unpins once
        the last reader is gone."""
        run.readers -= 1
        if run.readers <= 0 and run.evict_pending:
            self._unpin(run)

    def reclaim(self, n_blocks: int, order=None) -> int:
        """Pool-pressure backpressure: unpin zero-reader runs until
        roughly ``n_blocks`` pool blocks were freed. Victim order comes
        from ``order`` (the chunk store passes its eviction policy's
        ranking — least valuable first); without one, materialization
        (dict) order applies. Returns the number actually freed; the
        variants stay in the store, so a later hit simply
        re-materializes. Without this, accumulated cold runs could pin
        the whole pool and starve admissions forever."""
        cands = [r for r in self.runs.values()
                 if r.readers <= 0 and not r.evict_pending]
        if order is not None:
            cands = order(cands)
        freed = 0
        for run in cands:
            if freed >= n_blocks:
                break
            # only the owner ref frees a block; readers-gone means
            # every block drops to refcount 0 here
            freed += sum(1 for b in run.blocks
                         if self.pool.refs[b] == 1)
            self._unpin(run)
            self.pool.counters.run_reclaims += 1
        return freed

    def evict(self, variant_id: str):
        """Variant left the store: unpin its runs now, or defer each
        run's unpin until its readers drain."""
        for run in [r for r in self.runs.values()
                    if r.variant_id == variant_id]:
            if run.readers > 0:
                run.evict_pending = True
                self.pool.counters.run_unpins_deferred += 1
            else:
                self._unpin(run)

    def _unpin(self, run: SharedRun):
        self.pool.release(run.blocks)        # the store's owning ref
        self.runs.pop(run.key, None)
        self.pool.counters.run_unpins += 1


class ChunkStore:
    def __init__(self, tiers: TieredStore, n_chunks: int = 100,
                 m_variants: int = 5, alpha: float = 1.0,
                 use_beta: bool = True, quantize_kv: bool = False,
                 policy=None, layered_kv: bool = True):
        self.tiers = tiers
        self.n_chunks = n_chunks
        self.m_variants = m_variants
        self.alpha = alpha
        self.use_beta = use_beta      # Fig. 26 ablation: CFO without beta'
        # beyond-paper: int8 chunk-caches (per-token scales) — 4x more
        # chunks per tier; composes with the paper's §7 quantization note
        self.quantize_kv = quantize_kv
        # shared victim-selection source (see module docstring); the
        # reuse-aware default reproduces the historical f_r capping rule
        self.policy: EvictionPolicy = get_policy(policy) \
            if policy is not None else ReuseAwarePolicy()
        self.layered_kv = layered_kv
        self.table: Dict[str, List[Variant]] = {}
        self._by_vid: Dict[str, Variant] = {}
        self._counter = itertools.count()
        self._access_clock = itertools.count(1)
        self.evictions = 0
        self.residency: Optional[PoolResidency] = None
        # feed per-variant reuse stats (and layer-key -> variant-id pin
        # grouping) into the tier store's eviction candidates
        tiers.attach_stats(self._tier_stats, self._tier_group)

    # ---- tier-key plumbing (layer-sliced storage) -------------------------
    @staticmethod
    def _lkey(vid: str, layer: int) -> str:
        return f"{vid}@L{layer:02d}"

    @staticmethod
    def _tier_group(key: str) -> str:
        """Pin-group + stats alias: a layer-slice key belongs to its
        variant id."""
        return key.split("@L", 1)[0]

    def _tier_stats(self, key: str) -> tuple:
        var = self._by_vid.get(self._tier_group(key))
        if var is None:
            return 0.0, 1.0
        return var.f_r, float(max(1, var.num_tokens))

    def _tier_keys(self, var: Variant) -> List[str]:
        if var.num_layers:
            return [self._lkey(var.variant_id, l)
                    for l in range(var.num_layers)]
        return [var.variant_id]

    # ---- pool residency (zero-copy chunk sharing) ------------------------
    def attach_pool(self, pool) -> PoolResidency:
        """Wire the store to the serving KVPool so chunk-cache hits can
        be pinned once and shared across requests' block tables. One
        store serves one pool at a time: a re-attach (sequential
        engines over one store) drains the previous pool's zero-reader
        runs — tier pins included — and only errors if readers are
        still live there (a silent swap would leak the old pool's
        owning refs and desynchronize tier pin counts)."""
        if self.residency is not None and self.residency.pool is not pool:
            self.reclaim_pool_runs(pool.num_blocks + self.residency
                                   .pool.num_blocks)
            if self.residency.runs:
                raise ValueError(
                    "ChunkStore already attached to a different KVPool "
                    "with live readers; use one store per pool (or "
                    "finish the old engine's requests first)")
            self.residency = PoolResidency(pool)
        elif self.residency is None:
            self.residency = PoolResidency(pool)
        return self.residency

    def _run_order(self, runs: List[SharedRun]) -> List[SharedRun]:
        """Rank reclaim victims with the shared eviction policy:
        candidates carry the owning variant's reuse stats, so the
        reuse-aware policy unpins the least-likely-to-be-reshared run
        first instead of blind materialization order."""
        bnb = getattr(self.residency.pool, "block_nbytes", 1)
        cands = []
        for run in runs:
            var = self._by_vid.get(run.variant_id)
            cands.append(Candidate(
                key=run, nbytes=len(run.blocks) * bnb,
                last_access=run.last_used,
                reuse_freq=var.f_r if var else 0.0,
                recompute_cost=float(max(1, var.num_tokens)) if var
                else 1.0))
        return [c.key for c in self.policy.order(cands)]

    def reclaim_pool_runs(self, n_blocks: int) -> int:
        """Free ~``n_blocks`` pool blocks by unpinning zero-reader runs
        (tier pins released alongside), policy-ordered. Admission-side
        backpressure."""
        if self.residency is None:
            return 0
        before = dict(self.residency.runs)
        freed = self.residency.reclaim(n_blocks, order=self._run_order)
        for key, run in before.items():
            if key not in self.residency.runs:
                self.tiers.unpin(run.variant_id)
        return freed

    def pin_pool_run(self, variant: "Variant", start: int,
                     loader: Callable[[], Optional[tuple]],
                     reservation=None) -> Optional[SharedRun]:
        """Acquire (materializing if needed) the shared pool run for
        ``variant`` at layout ``start``; the variant's tier entry is
        pinned against demotion while pool-resident. Returns None when
        no pool is attached or the pin cannot be satisfied."""
        if self.residency is None:
            return None
        fresh = not self.residency.resident(variant.variant_id, start)
        run = self.residency.acquire(variant, start, loader, reservation)
        if run is not None and fresh:
            self.tiers.pin(variant.variant_id)
        return run

    def release_pool_run(self, run: SharedRun):
        """Drop one reader; the tier pin follows the run's lifetime."""
        if self.residency is None:
            return
        self.residency.release(run)
        if run.key not in self.residency.runs:
            self.tiers.unpin(run.variant_id)

    # ---- capacity --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.n_chunks * self.m_variants

    def num_variants(self) -> int:
        return sum(len(v) for v in self.table.values())

    # ---- insertion -------------------------------------------------------
    def add_variant(self, chash: str, kv, scores: ChunkScores) -> Variant:
        vid = f"{chash}-v{next(self._counter)}"
        if self.quantize_kv:
            kv = _quantize_kv(kv)
        nb = tree_nbytes(kv)
        L = 0
        if self.layered_kv:
            lead = kv.get("k", kv.get("k_q"))
            L = int(np.asarray(lead).shape[0])
        var = Variant(variant_id=vid, chunk_hash=chash, scores=scores,
                      num_tokens=scores.length, nbytes=nb, num_layers=L,
                      last_access=float(next(self._access_clock)))
        self._by_vid[vid] = var
        if L:
            # one tier entry per layer slice: the unit of demotion,
            # prefetch and streamed loading (Eq. 16)
            for l in range(L):
                self.tiers.put(self._lkey(vid, l),
                               {name: np.asarray(arr)[l]
                                for name, arr in kv.items()})
        else:
            self.tiers.put(vid, kv)
        self.table.setdefault(chash, []).append(var)
        self._evict_if_needed()
        return var

    def _variant_candidates(self) -> List[Candidate]:
        return [Candidate(key=v, nbytes=v.nbytes,
                          last_access=v.last_access, reuse_freq=v.f_r,
                          recompute_cost=float(max(1, v.num_tokens)))
                for variants in self.table.values() for v in variants]

    def _evict_if_needed(self):
        while self.num_variants() > self.capacity:
            worst = self.policy.select(self._variant_candidates())
            if worst is None:
                return
            self.remove(worst.key)
            self.evictions += 1

    def remove(self, var: Variant):
        self.table[var.chunk_hash].remove(var)
        if not self.table[var.chunk_hash]:
            del self.table[var.chunk_hash]
        for key in self._tier_keys(var):
            self.tiers.delete(key)
        self.tiers.pins.pop(var.variant_id, None)
        self._by_vid.pop(var.variant_id, None)
        if self.residency is not None:
            # pool-resident runs unpin now, or on the last reader's
            # release when the eviction races live requests
            self.residency.evict(var.variant_id)

    # ---- lookup ----------------------------------------------------------
    def lookup(self, chash: str) -> List[Variant]:
        return self.table.get(chash, [])

    def best_variant(self, chash: str, new_prefix_hashes: Sequence[str]
                     ) -> Optional[Tuple[Variant, float]]:
        """Select the variant minimizing CFO for the new prefix (§3.3)."""
        best, best_cfo = None, None
        for v in self.lookup(chash):
            if self.use_beta:
                c = cfo_fn(v.scores, new_prefix_hashes, self.alpha)
            else:
                c = float(min(1.0, self.alpha * v.scores.cci))
            if best_cfo is None or c < best_cfo:
                best, best_cfo = v, c
        if best is None:
            return None
        return best, best_cfo

    def record_use(self, var: Variant, cfo_value: float):
        var.f_r += 1.0 / max(cfo_value, 1e-3)
        var.uses += 1
        var.last_access = float(next(self._access_clock))

    def prefetch(self, chash: str, new_prefix_hashes: Sequence[str] = (),
                 ticket: Optional[PrefetchTicket] = None):
        hit = self.best_variant(chash, new_prefix_hashes)
        if hit is not None:
            for key in self._tier_keys(hit[0]):
                self.tiers.prefetch(key, ticket)

    def get_kv(self, var: Variant):
        if var.num_layers:
            slices, infos = [], []
            for l in range(var.num_layers):
                kv_l, info = self.tiers.get(self._lkey(var.variant_id, l))
                if kv_l is None:
                    return None, None
                slices.append(kv_l)
                infos.append(info)
            kv = {name: np.stack([s[name] for s in slices])
                  for name in slices[0]}
            info = merge_load_infos(infos)
        else:
            kv, info = self.tiers.get(var.variant_id)
        if kv is not None and "k_q" in kv:
            kv = _dequantize_kv(kv)
        return kv, info

    def get_kv_layer(self, var: Variant, layer: int):
        """One layer slice of a layered variant's stored (de-roped) KV,
        dequantized: ({'k': [S,H,D], 'v': [S,H,D]}, LoadInfo). The unit
        the layer-wise streamed loads (``core.preload.LayerStream``)
        await on."""
        assert var.num_layers, "variant is not layer-sliced"
        kv, info = self.tiers.get(self._lkey(var.variant_id, layer))
        if kv is not None and "k_q" in kv:
            kv = _dequantize_kv(kv)
        return kv, info

    # ---- introspection (Fig. 25 cache-store snapshot) ----------------------
    def snapshot(self):
        return {h: len(vs) for h, vs in self.table.items()}


def _quantize_kv(kv):
    """int8 with per-(layer, token) scales over the (heads, dim) tile."""
    out = {}
    for name in ("k", "v"):
        x = np.asarray(kv[name], np.float32)
        scale = np.abs(x).max(axis=(2, 3), keepdims=True) / 127.0 + 1e-12
        out[name + "_q"] = np.clip(np.round(x / scale), -127,
                                   127).astype(np.int8)
        out[name + "_s"] = scale.astype(np.float32)
    return out


def _dequantize_kv(kv):
    return {name: kv[name + "_q"].astype(np.float32) * kv[name + "_s"]
            for name in ("k", "v")}

"""End-to-end serving engine, in PyTorch: continuous batching +
Cache-Craft prefill, on ``cuda`` unless the caller asks for ``cpu``.

Timing model: compute is *measured* (each timed region ends with a device
synchronise, since PyTorch returns before the card finishes); the engine
clock advances by measured compute plus the *modeled* tier load costs
that queue wait does not hide (paper §3.5 async preload; Eq. 16
layer-wise preload hides the rest behind layer execution).

KV accounting is reservation-based: the scheduler reserves every
admitted request's blocks up front (``KVPool.reserve``), prefill writes
and decode appends draw from the reservation, and terminal states commit
(success) or cancel (requeue/failure) it.

Decode batch, two modes sharing one request-per-row map:

* **arena** (default): a bucketed (B, S) device cache; joins write the
  new request's gathered KV into a free row in place, leaves mask the row
  (position row -1) and recycle it; a full gather rebuild happens only
  when the bucketed (B, S) shape must grow.
* **paged** (``paged_decode=True``): attention reads K/V in place from a
  device twin of the pool's block arenas, indexed per request by compact
  slot rows (``paged``) or block rows (``paged_kernel``). Joins and leaves
  are row-map updates; the twin stays coherent by uploading the pool's
  dirty blocks before each step (``paged_block_syncs`` /
  ``paged_sync_bytes``) while ``decode_gather_bytes`` stays 0.

Zero-copy chunk sharing (``share_chunk_kv``, on with a store): the
write-back attaches hit chunks' canonical pool-resident runs
(``KVPool.append_shared``), CoWs recompute fixup rows, and allocates
fresh blocks only for miss/question segments; admission reserves only
the delta blocks (``_estimate_blocks``).

Tensor-parallel serving (``mesh``, a ``launch.mesh.make_serving_mesh``
mesh): the engine validates the head split (``serving_kv_shards``),
installs the mesh in the attention backend (``set_serving_mesh``),
forces ``attn_impl="sharded"`` and keeps a head-sharded pool
(``kv_shards``), as the reference does; ``attn_flops_device`` counts
one shard's share.

Preemption, cancellation and expiry share one ``_teardown``: shared-run
readers released, table blocks and the open reservation reclaimed in one
pool op, so ``free + live + reserved == num_blocks`` holds throughout.
Queue-driven tier prefetch runs every iteration under cancellable
tickets. See ``repro/serving/engine.py`` for the full design notes.

bf16 (``cfg.dtype="bfloat16"``, as ``cfg.replace(dtype="bfloat16",
param_dtype="bfloat16")`` gives): weights and activations in bf16 over
the fp32 caches of the executor, the decode arena and the pool, as in the
reference. Its engine serves that on ``attn_impl="kernel"`` alone: the
chunk and decode kernels take bf16 q over fp32 K/V and write bf16, while
every other route returns fp32 attention into the bf16 residual and
fails in the first prefill (or, with ``paged_decode``, the first decode
step). The port refuses those routes when the engine (or an executor)
is built (``core.prefill.check_bf16_route``, ROADMAP C12).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.chunkstore import ChunkStore, prompt_hashes
from repro_torch.core.prefill import CacheCraftExecutor, \
    check_bf16_route, decode_fn, inject_chunk_kv, pack_paged_cache, \
    paged_decode_fn, paged_sync_fn
from repro_torch.core.preload import preload_depth
from repro_torch.core.tiers import PrefetchTicket
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.metrics import ServingCounters
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


def _bucket(n: int, b: int) -> int:
    return max(b, -(-n // b) * b)


def _join_row(cfg, cache, row: int, k, v, pos):
    """In-place decode-batch join: write one request's gathered KV
    [L, S, Hkv, D] (+ pos [S]) into batch row ``row`` of the arena."""
    P, G = len(cfg.pattern), cfg.n_groups
    if G:
        kg = k[:G * P].reshape((G, P) + tuple(k.shape[1:]))
        vg = v[:G * P].reshape((G, P) + tuple(v.shape[1:]))
        for p in range(P):
            c = cache["groups"][p]
            c["k"][:, row] = kg[:, p]
            c["v"][:, row] = vg[:, p]
            c["pos"][:, row] = pos
    for i in range(cfg.n_tail):
        t = cache["tail"][i]
        t["k"][row] = k[G * P + i]
        t["v"][row] = v[G * P + i]
        t["pos"][row] = pos


def _leave_row(cache, row: int):
    """In-place decode-batch leave: mask batch row ``row`` by setting its
    position row to -1 (KV left in place: the position mask makes the row
    inert, and the next join overwrites it)."""
    for c in cache["groups"]:
        c["pos"][:, row] = -1
    for t in cache["tail"]:
        t["pos"][row] = -1


@dataclass
class EngineStats:
    prefill_tokens_total: int = 0
    prefill_tokens_computed: int = 0
    decode_steps: int = 0
    prefills: int = 0
    prefill_batches: int = 0            # packed prefill passes executed
    prefill_batch_max: int = 0          # most prefills admitted in one pass
    completed: int = 0
    failed: int = 0
    cancelled: int = 0                  # user-cancelled (Engine.cancel)
    clock: float = 0.0
    load_hidden_s: float = 0.0
    load_exposed_s: float = 0.0
    tier_quant_bytes_saved: int = 0
    tier_dequant_loads: int = 0
    # measured device-synchronised seconds (the clock also holds modeled
    # load time): prefill passes and decode steps
    prefill_compute_s: float = 0.0
    decode_compute_s: float = 0.0

    def stats_dict(self) -> dict:
        return dataclasses.asdict(self)


class Engine:
    def __init__(self, cfg: ModelConfig, params,
                 store: Optional[ChunkStore] = None, *,
                 sched: Optional[SchedulerConfig] = None,
                 pool_blocks: int = 4096, block_size: int = 16,
                 decode_bucket_b: int = 4, seq_bucket: int = 64,
                 strategy: str = "cachecraft",
                 use_focus: bool = True,
                 force_recompute_fraction: Optional[float] = None,
                 layerwise_load: bool = False,
                 store_fixed_variants: bool = True,
                 store_new_chunks: bool = True,
                 fix_rpe: bool = True, fix_causality: bool = True,
                 time_scale: float = 1.0,
                 incremental_decode: bool = True,
                 share_chunk_kv: bool = True,
                 trace_decode: bool = False,
                 attn_impl: Optional[str] = None,
                 paged_decode: bool = False,
                 mesh=None,
                 device="cuda"):
        self.device = devmod.resolve(device)
        self.cfg = cfg
        self.params = params
        self.store = store
        # attention backend (models.backend.BACKENDS). None keeps the
        # reference's split: "dense" prefill windows, "auto" decode. A
        # serving mesh forces "sharded" and a head-sharded pool
        self.mesh = mesh
        check_bf16_route(cfg, "sharded" if mesh is not None else attn_impl,
                         paged_decode, who="Engine")
        kv_shards = 1
        if mesh is not None:
            from repro_torch.distributed.sharding import serving_kv_shards
            from repro_torch.models import backend as AB
            kv_shards = serving_kv_shards(mesh, cfg)
            AB.set_serving_mesh(mesh)
            attn_impl = "sharded"
        self.attn_impl = attn_impl
        self.kv_shards = kv_shards
        ek = dict(strategy=strategy, use_focus=use_focus,
                  force_recompute_fraction=force_recompute_fraction,
                  layerwise_load=layerwise_load,
                  store_fixed_variants=store_fixed_variants,
                  store_new_chunks=store_new_chunks,
                  fix_rpe=fix_rpe, fix_causality=fix_causality,
                  device=self.device)
        if attn_impl is not None:
            ek["attn_impl"] = attn_impl
        self.executor = CacheCraftExecutor(cfg, params, store, **ek)
        self.scheduler = Scheduler(sched or SchedulerConfig())
        self.counters = ServingCounters()
        self.pool = KVPool(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_,
                           pool_blocks, block_size, counters=self.counters,
                           kv_shards=kv_shards)
        # zero-copy chunk sharing needs a store AND layout-local positions
        # (fix_rpe/fix_causality); a recompute fraction of 1.0 rewrites
        # every cached row, leaving nothing shareable
        frac = self.executor.force_recompute_fraction
        self.share_chunk_kv = bool(
            share_chunk_kv and store is not None
            and self.executor.fix_rpe and self.executor.fix_causality
            and (frac is None or frac < 1.0))
        if self.share_chunk_kv:
            store.attach_pool(self.pool)
        self.decode_bucket_b = decode_bucket_b
        self.seq_bucket = seq_bucket
        self.time_scale = time_scale
        self.incremental_decode = incremental_decode
        self.clock = 0.0
        self.decoding: List[Request] = []
        self._dcache = None
        self._dshape = None
        self._rows: List[Optional[Request]] = []   # batch row -> request
        self._masked_rows: set = set()             # rows freed by a leave
        self._needs_rebuild = True
        self.stats = EngineStats()
        # test/bench support: per-step decode logits and final pool KV
        self.trace_decode = trace_decode
        self.decode_trace: List[Dict[int, np.ndarray]] = []
        self.final_kv: Dict[int, tuple] = {}
        # online serving support: per-token events for drain_tokens, and
        # cancels requested from other threads, applied by ``step``
        self._token_events: List[Tuple[int, int]] = []
        self._events_lock = threading.Lock()
        self._cancel_pending: set = set()
        self._decode_fn = decode_fn(cfg, self.attn_impl or "auto")
        self.paged_decode = bool(paged_decode)
        self._pcache = None
        self._paged_kernel = bool(paged_decode) and \
            self.attn_impl == "paged_kernel"
        if paged_decode:
            impl = self.attn_impl \
                if self.attn_impl in ("paged", "paged_kernel") else "paged"
            self._paged_fn = paged_decode_fn(cfg, impl, block_size)
            self._psync = paged_sync_fn(cfg)

    def _dev(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ---- submission ---------------------------------------------------------
    def submit(self, req: Request):
        self.clock = max(self.clock, req.arrival_time)
        self.scheduler.enqueue(req, self.clock)

    def _prefetch_lookahead(self):
        """Issue tier promotions for queued requests entering the
        scheduler's look-ahead window, each under a cancellable ticket."""
        if self.store is None:
            return
        for req in self.scheduler.prefetch_targets():
            if req.prompt_hashes is None:
                req.prompt_hashes = prompt_hashes(req.system_tokens,
                                                  req.chunk_tokens)
            req.prefetch_ticket = PrefetchTicket()
            for i, h in enumerate(req.prompt_hashes):
                self.store.prefetch(h, req.prompt_hashes[:i],
                                    ticket=req.prefetch_ticket)
            self.counters.prefetch_issued += 1

    # ---- per-token streaming ------------------------------------------------
    def _emit_token(self, req: Request, token: int):
        """Queue one (rid, token) event for ``drain_tokens``, at most once
        per output index (``Request.tokens_emitted`` survives
        ``reset_attempt``, so a retried attempt re-emits nothing)."""
        n = len(req.output_tokens)
        if n <= req.tokens_emitted:
            return
        req.tokens_emitted = n
        with self._events_lock:
            self._token_events.append((req.rid, token))

    def drain_tokens(self) -> List[Tuple[int, int]]:
        """Every (rid, token) pair produced since the last drain, in
        production order."""
        with self._events_lock:
            out = self._token_events
            self._token_events = []
        return out

    # ---- cancellation -------------------------------------------------------
    def request_cancel(self, rid: int):
        """Thread-safe cancellation request, applied at the top of the
        next ``step`` so device and pool state stay single-threaded."""
        self._cancel_pending.add(rid)

    def _process_cancels(self) -> bool:
        worked = False
        while self._cancel_pending:
            worked |= self.cancel(self._cancel_pending.pop())
        return worked

    def cancel(self, rid: int) -> bool:
        """Cancel one request mid-flight: still queued (removed, prefetch
        retracted) or mid-decode (row masked, shared-run readers released,
        blocks + reservation reclaimed), through ``_teardown``. Returns
        False when ``rid`` is unknown or already terminal."""
        for r in self.scheduler.queue:
            if r.rid == rid:
                self.scheduler.queue.remove(r)
                self._finish_cancel(r)
                return True
        for r in self.decoding:
            if r.rid == rid:
                row = next((i for i, q in enumerate(self._rows)
                            if q is r), None)
                self.decoding.remove(r)
                if row is not None:
                    self._decode_leave(row)
                else:
                    self._needs_rebuild = True
                self._finish_cancel(r)
                return True
        return False

    def _finish_cancel(self, req: Request):
        self._teardown(req)
        req.state = State.CANCELLED
        self.stats.cancelled += 1
        self.scheduler.on_terminal(req)

    # ---- one ORCA iteration -------------------------------------------------
    def step(self) -> bool:
        """Returns True if any work was done."""
        worked = self._process_cancels()
        worked = self._expire_queued() or worked
        self._prefetch_lookahead()
        fails_before = self.counters.reserve_failures
        reqs = self._admit()
        if not reqs and self.scheduler.queue \
                and self.counters.reserve_failures > fails_before:
            # head-of-line reservation failure this iteration
            head = self.scheduler.queue[0]
            reclaimed = False
            if self.share_chunk_kv:
                # cold canonical runs (zero readers) must not pin the pool
                # while the queue starves
                need = self._estimate_blocks(head)
                if self.pool.free_blocks < need:
                    if self.store.reclaim_pool_runs(
                            need - self.pool.free_blocks):
                        reclaimed = worked = True
            stall = self.scheduler.note_head_stall(head.rid)
            self.counters.head_stall_iters_max = max(
                self.counters.head_stall_iters_max, stall)
            if not reclaimed:
                victims: List[Request] = []
                if self.scheduler.should_preempt():
                    # preempt newest-first, retrying admission after each
                    # victim; victims are requeued only after the head's
                    # retry so the freed blocks accumulate for the head
                    while not reqs:
                        victim = self.scheduler.select_victim(
                            self.decoding)
                        if victim is None:
                            break
                        self._preempt(victim)
                        victims.append(victim)
                        reqs = self._admit()
                if victims:
                    for victim in victims:
                        self.scheduler.preempt_requeue(victim)
                    worked = True
                elif not self._shortage_recoverable():
                    # shortage valve: burn a bounded retry so persistent
                    # shortage converges to FAILED, not a livelock
                    self.scheduler.requeue(self.scheduler.queue.popleft())
                    worked = True
        elif reqs:
            self.scheduler.note_head_progress()
        if reqs:
            self._run_prefills(reqs)
            worked = True
        if self.decoding:
            self._run_decode_step()
            worked = True
        return worked

    def _admit(self) -> List[Request]:
        return self.scheduler.next_prefills(
            sum(r.total_len for r in self.decoding), len(self.decoding),
            pool=self.pool,
            reserve_blocks_fn=self._estimate_blocks
            if self.share_chunk_kv else None)

    def _shortage_recoverable(self) -> bool:
        """Can blocks still come back without failing anyone (decode
        completions, or pool-resident runs at zero readers)?"""
        if self.decoding:
            return True
        if self.share_chunk_kv and self.store.residency is not None:
            return any(r.readers <= 0 and not r.evict_pending
                       for r in self.store.residency.runs.values())
        return False

    def _expire_queued(self) -> bool:
        """Straggler guard (``SchedulerConfig.deadline_s``): FAIL queued
        requests whose wait exceeded the deadline, with full teardown."""
        sched = self.scheduler
        if not sched.queue:
            return False
        if sched.cfg.deadline_s <= 0 and \
                not any(r.deadline_s > 0 for r in sched.queue):
            return False
        expired = [r for r in sched.queue if sched.expired(r, self.clock)]
        for r in expired:
            sched.queue.remove(r)
            self._teardown(r)
            r.state = State.FAILED
            r.deadline_hit = True
            self.counters.deadline_expired += 1
            sched.on_terminal(r)
        return bool(expired)

    def _count_attn_flops(self, tq: int, tk: int):
        """Analytic attention FLOPs for one pass (score + PV products over
        all layers, 4*Tq*Tk*H*D each); a head shard does 1/kv_shards of
        them."""
        f = 4 * tq * tk * self.cfg.num_heads * self.cfg.head_dim_ \
            * self.cfg.num_layers
        self.counters.attn_flops_total += f
        self.counters.attn_flops_device += f // self.kv_shards

    def _run_prefills(self, reqs: Sequence[Request]):
        """Packed multi-request prefill: every admitted request's
        recompute tokens execute as one windowed pass. Admission reserved
        each request's KV blocks, so the write-back cannot fail under
        pool pressure."""
        for req in reqs:
            req.state = State.PREFILLING
            req.t_prefill_start = self.clock
            if req.t_first_service is None:
                req.t_first_service = self.clock
        t0 = time.perf_counter()
        results = self.executor.process_batch(
            [(r.system_tokens, r.chunk_tokens, r.question_tokens)
             for r in reqs])
        devmod.sync(self.device)
        wall = time.perf_counter() - t0
        self.stats.prefill_compute_s += wall
        compute_s = wall * self.time_scale
        # tier loads: streamed passes measured the overlap at their await
        # points; eager passes keep the modeled account (queue wait hides
        # loading, Eq. 16 preload hides the remainder behind compute)
        exposed_max = 0.0
        for req, res in zip(reqs, results):
            if res.streamed:
                exposed = res.load_exposed_measured * self.time_scale
                self.stats.load_exposed_s += exposed
                self.stats.load_hidden_s += max(
                    0.0, min(res.load_seconds_measured,
                             res.load_span_measured) * self.time_scale
                    - exposed)
                self.counters.preload_layers_blocked += \
                    res.load_blocked_layers
                self.counters.preload_layers_hidden += \
                    res.load_hidden_layers
                continue
            t_enq = req.t_enqueued if req.t_enqueued is not None \
                else self.clock
            queue_wait = self.clock - t_enq
            lp = preload_depth(self.cfg.num_layers,
                               compute_s / max(1, self.cfg.num_layers),
                               res.load_seconds_modeled /
                               max(1, self.cfg.num_layers))
            exposed = max(0.0, res.load_seconds_modeled *
                          (lp / self.cfg.num_layers) - queue_wait)
            self.stats.load_hidden_s += res.load_seconds_modeled - exposed
            self.stats.load_exposed_s += exposed
            exposed_max = max(exposed_max, exposed)
        self.clock += compute_s + exposed_max
        self.stats.prefill_batches += 1
        self.stats.prefill_batch_max = max(self.stats.prefill_batch_max,
                                           len(reqs))

        joined: List[Request] = []
        for req, res in zip(reqs, results):
            ok = self._write_back(req, res)
            if not ok:
                # zero-copy: the delta estimate does not budget CoW clones,
                # so a tight pool can fail the write-back; the retry takes
                # a full reservation + copy-style write-back
                self.counters.burn_requeues += 1
                req.reserve_full = True
                self._requeue(req)
                continue
            first = int(np.argmax(res.logits_last[:self.cfg.vocab_size]))
            self._count_attn_flops(res.plan.num_active_tokens,
                                   res.total_len)
            req.output_tokens.append(first)
            self._emit_token(req, first)
            req.total_len = res.total_len
            req.t_first_token = self.clock
            req.prefill_tokens_total = res.total_len
            req.prefill_tokens_computed = res.plan.num_active_tokens
            req.cache_hits = sum(d.is_hit for d in res.plan.decisions)
            req.load_seconds_modeled = res.load_seconds_modeled
            req.state = State.DECODING
            self.stats.prefills += 1
            self.stats.prefill_tokens_total += res.total_len
            self.stats.prefill_tokens_computed += res.plan.num_active_tokens
            self.counters.delta_blocks_saved += req.delta_blocks_saved
            req.delta_blocks_saved = 0
            self.decoding.append(req)
            joined.append(req)
        self._decode_join_batch(joined)

    # ---- zero-copy chunk sharing -------------------------------------------
    def _run_loader(self, variant, start: int, length: int):
        """Loader for a canonical pool run: the variant's stored KV roped
        at the layout span via the same ``inject_chunk_kv`` the executor
        uses (byte identity is the zero-copy bit-equality contract)."""
        def load():
            kv, _info = self.store.get_kv(variant)
            if kv is None:
                return None
            span = np.arange(start, start + length, dtype=np.int32)
            k, v = inject_chunk_kv(self.cfg, kv, span, device=self.device)
            return k, v, span
        return load

    def _write_back(self, req: Request, res) -> bool:
        """Persist one prefill result into the request's block table:
        copy mode writes it densely; zero-copy mode attaches hit chunks'
        shared runs (recompute rows CoW'd in) and gives miss chunks and
        the question fresh block-aligned segments."""
        pool, plan = self.pool, res.plan
        if not self.share_chunk_kv or req.reserve_full:
            return pool.write_prefill(req.table, res.k_layers,
                                      res.v_layers, res.pos_layout,
                                      reservation=req.reservation)
        table = req.table
        for d in plan.decisions:
            seg = d.seg
            if seg.length == 0:
                continue
            if d.is_hit and len(d.recompute_idx) < seg.length:
                run = self.store.pin_pool_run(
                    d.variant, seg.start,
                    self._run_loader(d.variant, seg.start, seg.length),
                    reservation=req.reservation)
                if run is not None:
                    base = pool.append_shared(table, run.blocks)
                    req.shared_runs.append(run)
                    self.counters.shared_seg_hits += 1
                    ridx = np.asarray(d.recompute_idx, np.int64)
                    if ridx.size and not pool.write_rows(
                            table, base + ridx,
                            res.k_layers[:, seg.start + ridx],
                            res.v_layers[:, seg.start + ridx],
                            res.pos_layout[seg.start + ridx],
                            reservation=req.reservation):
                        return False
                    continue
            if pool.append_segment(
                    table, res.k_layers[:, seg.start:seg.end],
                    res.v_layers[:, seg.start:seg.end],
                    res.pos_layout[seg.start:seg.end],
                    reservation=req.reservation) is None:
                return False
        q = plan.question
        if q.length == 0:
            return True
        return pool.append_segment(
            table, res.k_layers[:, q.start:q.end],
            res.v_layers[:, q.start:q.end], res.pos_layout[q.start:q.end],
            reservation=req.reservation) is not None

    def _release_runs(self, req: Request):
        for run in req.shared_runs:
            self.store.release_pool_run(run)
        req.shared_runs = []

    def _estimate_blocks(self, req: Request) -> int:
        """Delta-aware admission estimate: segments covered by an
        already-resident shared run cost zero new blocks; everything else
        counts at block-aligned granularity (plus the question + decode
        tail). Layout and hit selection mirror ``build_plan``."""
        bs = self.pool.block_size
        if req.reserve_full:
            req.delta_blocks_saved = 0
            return self.pool.blocks_needed(Scheduler._need(req))
        parts = [np.asarray(req.system_tokens)] + \
            [np.asarray(c) for c in req.chunk_tokens]
        if req.prompt_hashes is None:
            req.prompt_hashes = prompt_hashes(parts[0], parts[1:])
        hashes = req.prompt_hashes
        residency = self.store.residency
        predict = self.executor.strategy_obj.predicts_residency
        blocks = full = 0
        start = 0
        for i, part in enumerate(parts):
            n = -(-len(part) // bs)
            full += n
            shared = False
            if predict and residency is not None:
                hit = self.store.best_variant(hashes[i], hashes[:i])
                shared = hit is not None and \
                    residency.resident(hit[0].variant_id, start)
            if not shared:
                blocks += n
            start += len(part)
        tail = -(-(len(req.question_tokens) + req.max_new_tokens) // bs)
        req.delta_blocks_saved = full - blocks
        return blocks + tail

    def _teardown(self, req: Request) -> int:
        """Release every pool resource a burned attempt holds (prefetch
        ticket, shared-run readers, table blocks, open reservation);
        returns the blocks returned to the free list."""
        if req.prefetch_ticket is not None:
            req.prefetch_ticket.cancel()
            req.prefetch_ticket = None
            self.counters.prefetch_cancels += 1
        before = self.pool.free_blocks
        self._release_runs(req)
        self.pool.reclaim_request(req.table, req.reservation)
        req.reservation = None
        return self.pool.free_blocks - before

    def _requeue(self, req: Request):
        """Return a request to the queue with its per-attempt state reset."""
        self._teardown(req)
        req.reset_attempt()
        self.scheduler.requeue(req)

    def _preempt(self, req: Request):
        """Preempt one decode request for a starved queue head: leave its
        decode row, tear down its pool state and reset it for re-entry as
        a normal prefill (the caller requeues it after the head's
        retried admission)."""
        row = next((i for i, r in enumerate(self._rows) if r is req),
                   None)
        self.decoding.remove(req)
        if row is not None:
            self._decode_leave(row)
        else:
            self._needs_rebuild = True
        recovered = self._teardown(req)
        req.reserve_full = False
        req.reset_attempt()
        self.counters.preemptions += 1
        self.counters.preempt_block_recovered += recovered

    # ---- decode batch -------------------------------------------------------
    def _row_capacity(self, req: Request) -> int:
        """Arena sequence slots this request may touch while decoding."""
        return req.total_len + req.max_new_tokens + 1

    def _rebuild_decode_batch(self):
        B = _bucket(len(self.decoding), self.decode_bucket_b)
        max_len = max(self._row_capacity(r) for r in self.decoding)
        S = _bucket(max_len, self.seq_bucket)
        self._dshape = (B, S)
        self._rows = list(self.decoding) + [None] * (B - len(self.decoding))
        self._masked_rows = set()
        self._needs_rebuild = False
        self.counters.decode_rebuilds += 1
        if self.paged_decode:
            # paged rebuild = re-bucket the index rows: no gather, no
            # transfer (decode_gather_bytes unchanged)
            return
        L = self.cfg.num_layers
        hkv, dh = self.cfg.num_kv_heads, self.cfg.head_dim_
        k = np.zeros((L, B, S, hkv, dh), np.float32)
        v = np.zeros_like(k)
        pos = np.full((B, S), -1, np.int32)
        for i, r in enumerate(self.decoding):
            kk, vv, pp = self.pool.gather(r.table, S, compact=True)
            self.counters.decode_gather_bytes += kk.nbytes + vv.nbytes
            k[:, i], v[:, i], pos[i] = kk, vv, pp
        P, G = len(self.cfg.pattern), self.cfg.n_groups
        groups = []
        if G:
            kt = self._dev(k[:G * P]).reshape(G, P, B, S, hkv, dh)
            vt = self._dev(v[:G * P]).reshape(G, P, B, S, hkv, dh)
            pt = self._dev(pos)
            for p in range(P):
                groups.append({"k": kt[:, p].contiguous(),
                               "v": vt[:, p].contiguous(),
                               "pos": pt.expand(G, B, S).clone()})
        tail = [{"k": self._dev(k[G * P + i]), "v": self._dev(v[G * P + i]),
                 "pos": self._dev(pos)} for i in range(self.cfg.n_tail)]
        self._dcache = {"groups": groups, "tail": tail}

    def _decode_join_batch(self, reqs: Sequence[Request]):
        """Join newly-decoding requests into the decode batch in place, or
        flag a (lazy) full rebuild when there is no batch yet, not enough
        free rows, or the rows are too short for any of them."""
        if not reqs:
            return
        have_batch = self._dshape is not None if self.paged_decode \
            else self._dcache is not None
        if not self.incremental_decode or not have_batch or \
                self._needs_rebuild:
            self._needs_rebuild = True
            return
        _B, S = self._dshape
        if len(reqs) > self._rows.count(None) or \
                any(self._row_capacity(r) > S for r in reqs):
            self._needs_rebuild = True
            return
        for req in reqs:
            self._decode_join(req)

    def _decode_join(self, req: Request):
        """Write one newly-decoding request's gathered KV into a free
        batch row in place (paged joins only update the row map)."""
        _B, S = self._dshape
        row = self._rows.index(None)
        if not self.paged_decode:
            k, v, pos = self.pool.gather(req.table, S, compact=True)
            self.counters.decode_gather_bytes += k.nbytes + v.nbytes
            self.counters.decode_join_copies += 1
            _join_row(self.cfg, self._dcache, row, self._dev(k),
                      self._dev(v), self._dev(pos))
        self._rows[row] = req
        self.counters.decode_joins += 1
        if row in self._masked_rows:
            self._masked_rows.discard(row)
            self.counters.decode_rows_recycled += 1

    def _decode_leave(self, row: int):
        """Mask a departing request's batch row; the next join recycles
        it. In rebuild mode the whole batch is regathered instead."""
        self._rows[row] = None
        if not self.incremental_decode:
            self._needs_rebuild = True
            return
        if self.paged_decode:
            if self._dshape is None or self._needs_rebuild:
                return
            self._masked_rows.add(row)
            self.counters.decode_leaves += 1
            return
        if self._dcache is None or self._needs_rebuild:
            return
        _leave_row(self._dcache, row)
        self._masked_rows.add(row)
        self.counters.decode_leaves += 1

    def _sync_dirty_blocks(self):
        """Upload the pool's dirty-block log into the device twin: one
        scatter of the touched blocks' flat slots (id list bucketed to 8).
        Counted honestly as ``paged_block_syncs`` / ``paged_sync_bytes``."""
        ids = self.pool.dirty_blocks()
        if not ids:
            return
        kp, vp, pp = self.pool.block_view()
        bs = self.pool.block_size
        m = _bucket(len(ids), 8)
        bid = np.full(m, -1, np.int64)
        bid[:len(ids)] = ids
        slots = bid[:, None] * bs + np.arange(bs)[None, :]
        slots = np.where(bid[:, None] >= 0, slots, -1).reshape(-1)
        idx = np.maximum(bid, 0)
        k = kp[:, idx].reshape(kp.shape[0], m * bs, *kp.shape[3:])
        v = vp[:, idx].reshape(vp.shape[0], m * bs, *vp.shape[3:])
        pos = np.where(slots >= 0, pp[idx].reshape(m * bs), -1)
        self._pcache = self._psync(
            self._pcache, self._dev(slots.astype(np.int32)), self._dev(k),
            self._dev(v), self._dev(pos.astype(np.int32)))
        self.counters.paged_block_syncs += len(ids)
        self.counters.paged_sync_bytes += int(
            kp[:, ids].nbytes + vp[:, ids].nbytes)
        self.pool.clear_dirty(ids)

    def _extract_pool_slot_kv(self, slot: int):
        """Read one flat pool slot's per-layer KV back from the device
        twin (the decode pass wrote the new token there): the host
        mirror's source, so host and twin bytes agree bit for bit."""
        cfg = self.cfg
        P, G = len(cfg.pattern), cfg.n_groups
        hkv, dh = cfg.num_kv_heads, cfg.head_dim_
        k = np.zeros((cfg.num_layers, hkv, dh), np.float32)
        v = np.zeros((cfg.num_layers, hkv, dh), np.float32)
        for p in range(P):
            kk = self._pcache["groups"][p]["kp"][:, slot].cpu().numpy()
            vv = self._pcache["groups"][p]["vp"][:, slot].cpu().numpy()
            for g in range(G):
                k[g * P + p] = kk[g]
                v[g * P + p] = vv[g]
        for i in range(cfg.n_tail):
            k[G * P + i] = self._pcache["tail"][i]["kp"][slot].cpu().numpy()
            v[G * P + i] = self._pcache["tail"][i]["vp"][slot].cpu().numpy()
        return k, v

    @torch.no_grad()
    def _run_decode_step_paged(self):
        """One decode iteration, block-table-native: (1) pre-open every
        live row's append slot (the one step that can fail under pool
        pressure, so it fails before any compute); (2) bring the device
        twin up to date (wholesale pack once, then dirty-block scatters);
        (3) run the pass, which splices each row's pre-opened slot into
        its index row and writes the new token's KV there; (4) mirror that
        KV into the host pool and drop the block from the dirty log."""
        if self._dshape is None or self._needs_rebuild:
            self._rebuild_decode_batch()
        B, S = self._dshape
        pslots = np.full(B, -1, np.int32)
        for i, r in enumerate(list(self._rows)):
            if r is None:
                continue
            s = self.pool.ensure_append_slot(r.table,
                                             reservation=r.reservation)
            if s is None:
                # zero-copy: CoW fixups may have drained the delta
                # reservation; escalate to a full reservation
                r.reserve_full = True
                self.decoding.remove(r)
                self._decode_leave(i)
                self._requeue(r)
                continue
            pslots[i] = s
        if not self.decoding:
            return
        if self._pcache is None:
            self._pcache = pack_paged_cache(self.cfg,
                                            *self.pool.block_view(),
                                            device=self.device)
            self.pool.clear_dirty(self.pool.dirty_blocks())
        else:
            self._sync_dirty_blocks()
        toks = np.zeros(B, np.int32)
        poss = np.full(B, -1, np.int32)
        rows = np.full((B, S), -1, np.int32)
        for i, r in enumerate(self._rows):
            if r is None:
                continue
            toks[i] = r.output_tokens[-1]
            poss[i] = r.total_len       # logical position (RoPE/causal)
            rows[i] = self.pool.table_slot_index(r.table, S)
        brows = None
        if self._paged_kernel:
            # the paged kernel walks physical blocks, so it needs the
            # block-id rows too (bucketed); the pre-opened append block's
            # unused slots carry pos == -1 and mask out in-kernel
            nbm = _bucket(max(len(r.table.blocks) for r in self._rows
                              if r is not None), 8)
            brows = np.full((B, nbm), -1, np.int32)
            for i, r in enumerate(self._rows):
                if r is not None:
                    brows[i] = self.pool.table_block_row(r.table, nbm)
        devmod.sync(self.device)
        t0 = time.perf_counter()
        logits, self._pcache = self._paged_fn(
            self.params, self._dev(toks), self._dev(poss), self._pcache,
            self._dev(pslots), self._dev(rows),
            None if brows is None else self._dev(brows))
        logits = logits[:, 0].float().cpu().numpy()
        wall = time.perf_counter() - t0
        self.stats.decode_compute_s += wall
        self.clock += wall * self.time_scale
        self.stats.decode_steps += 1
        self._count_attn_flops(B, S)
        if self.trace_decode:
            self.decode_trace.append(
                {r.rid: logits[i].copy()
                 for i, r in enumerate(self._rows) if r is not None})
        for i, r in enumerate(list(self._rows)):
            if r is None:
                continue
            nxt = int(np.argmax(logits[i, :self.cfg.vocab_size]))
            ktok, vtok = self._extract_pool_slot_kv(int(pslots[i]))
            self.pool.append_token(r.table, ktok, vtok, r.total_len,
                                   reservation=r.reservation)
            self.pool.clear_dirty([int(pslots[i])
                                   // self.pool.block_size])
            r.output_tokens.append(nxt)
            self._emit_token(r, nxt)
            r.total_len += 1
            if len(r.output_tokens) >= r.max_new_tokens:
                self._finish(r, i)

    def _finish(self, r: Request, row: int):
        r.state = State.DONE
        r.t_done = self.clock
        self.stats.completed += 1
        self.decoding.remove(r)
        self._decode_leave(row)
        if self.trace_decode:
            pad = _bucket(max(r.table.length, 1), self.seq_bucket)
            self.final_kv[r.rid] = self.pool.gather(r.table, pad)
        self.pool.free_table(r.table)
        self._release_runs(r)
        self.pool.commit(r.reservation)
        r.reservation = None
        self.scheduler.on_terminal(r)

    @torch.no_grad()
    def _run_decode_step(self):
        if self.paged_decode:
            return self._run_decode_step_paged()
        if self._dcache is None or self._needs_rebuild:
            self._rebuild_decode_batch()
        B, S = self._dshape
        toks = np.zeros(B, np.int32)
        poss = np.full(B, -1, np.int32)
        slots = np.full(B, -1, np.int32)
        for i, r in enumerate(self._rows):
            if r is None:                  # masked row: inert
                continue
            toks[i] = r.output_tokens[-1]
            poss[i] = r.total_len          # logical position (RoPE/causal)
            slots[i] = r.total_len         # arena append slot (compact
            #   logical view; the pool's block-aligned slot is private
            #   to append_token below)
        devmod.sync(self.device)
        t0 = time.perf_counter()
        logits, self._dcache = self._decode_fn(
            self.params, self._dev(toks), self._dev(poss), self._dcache,
            self._dev(slots))
        logits = logits[:, 0].float().cpu().numpy()
        wall = time.perf_counter() - t0
        self.stats.decode_compute_s += wall
        self.clock += wall * self.time_scale
        self.stats.decode_steps += 1
        self._count_attn_flops(B, S)
        if self.trace_decode:
            self.decode_trace.append(
                {r.rid: logits[i].copy() for i, r in enumerate(self._rows)
                 if r is not None})

        for i, r in enumerate(list(self._rows)):
            if r is None:
                continue
            nxt = int(np.argmax(logits[i, :self.cfg.vocab_size]))
            # persist the newly written KV into the paged pool
            ktok, vtok = self._extract_slot_kv(i, r.total_len)
            if not self.pool.append_token(r.table, ktok, vtok,
                                          r.total_len,
                                          reservation=r.reservation):
                # zero-copy: CoW fixups may have drained the delta
                # reservation; escalate the retry to a full reservation
                r.reserve_full = True
                self.decoding.remove(r)
                self._decode_leave(i)
                self._requeue(r)
                continue
            r.output_tokens.append(nxt)
            self._emit_token(r, nxt)
            r.total_len += 1
            if len(r.output_tokens) >= r.max_new_tokens:
                self._finish(r, i)

    def _extract_slot_kv(self, batch_idx: int, slot: int):
        cfg = self.cfg
        P, G = len(cfg.pattern), cfg.n_groups
        hkv, dh = cfg.num_kv_heads, cfg.head_dim_
        k = np.zeros((cfg.num_layers, hkv, dh), np.float32)
        v = np.zeros((cfg.num_layers, hkv, dh), np.float32)
        for p in range(P):
            kk = self._dcache["groups"][p]["k"][:, batch_idx, slot]
            vv = self._dcache["groups"][p]["v"][:, batch_idx, slot]
            kk, vv = kk.cpu().numpy(), vv.cpu().numpy()
            for g in range(G):
                k[g * P + p] = kk[g]
                v[g * P + p] = vv[g]
        for i in range(cfg.n_tail):
            k[G * P + i] = self._dcache["tail"][i]["k"][batch_idx, slot] \
                .cpu().numpy()
            v[G * P + i] = self._dcache["tail"][i]["v"][batch_idx, slot] \
                .cpu().numpy()
        return k, v

    # ---- workload driver ------------------------------------------------------
    def step_until_idle(self, *, max_iters: Optional[int] = None,
                        feed=None, on_step=None, idle=None) -> int:
        """The one serving loop: step until there is no work left.

        * ``feed() -> Optional[float]``: submit every request whose
          arrival is due and return the next *future* arrival time.
        * ``on_step()``: called after every ``step``.
        * ``idle() -> bool``: a step did no work and nothing is queued or
          known to arrive; True keeps looping.

        When a step does no work but arrivals are pending, the clock jumps
        to the next arrival. Returns the number of iterations executed."""
        iters = 0
        while max_iters is None or iters < max_iters:
            nxt = feed() if feed is not None else None
            if not (self.scheduler.queue or self.decoding
                    or nxt is not None):
                if idle is not None and idle():
                    continue
                break
            iters += 1
            worked = self.step()
            if on_step is not None:
                on_step()
            if not worked:
                if nxt is not None:      # idle: jump to next arrival
                    self.clock = max(self.clock, nxt)
                elif self.scheduler.queue:
                    continue             # waiting on reserve headroom
                elif not (idle is not None and idle()):
                    break
        return iters

    def run(self, requests: Sequence[Request],
            max_iters: int = 1_000_000) -> EngineStats:
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0

        def feed():
            nonlocal i
            while i < len(pending) and \
                    pending[i].arrival_time <= self.clock:
                self.submit(pending[i])
                i += 1
            return pending[i].arrival_time if i < len(pending) else None

        self.step_until_idle(max_iters=max_iters, feed=feed)
        self.stats.clock = self.clock
        self.stats.failed = sum(1 for r in requests
                                if r.state == State.FAILED)
        if self.store is not None and self.store.tiers is not None:
            tstats = self.store.tiers.stats
            self.stats.tier_quant_bytes_saved = \
                int(tstats.get("quant_bytes_saved", 0))
            self.stats.tier_dequant_loads = \
                int(tstats.get("dequant_loads", 0))
        return self.stats

    def stats_dict(self) -> dict:
        """One merged stats payload: engine stats + counters + pool."""
        d = self.stats.stats_dict()
        d["counters"] = self.counters.stats_dict()
        d["pool"] = dict(num_blocks=self.pool.num_blocks,
                         free_blocks=self.pool.free_blocks,
                         live_blocks=self.pool.live_blocks,
                         reserved_blocks=self.pool.reserved_blocks)
        return d

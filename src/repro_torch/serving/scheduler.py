"""ORCA-style iteration-level scheduler (paper §5.3 setup).

Continuous batching: at every engine iteration the scheduler drains as
many queued requests as fit the ORCA token budget (packed multi-request
prefill) while the decode batch keeps stepping. Chunk-caches for queued
requests are prefetched asynchronously so tier-load latency hides behind
queue wait (§3.5).

Admission is reservation-based when the engine hands over its ``KVPool``:
every admitted request (including the first) gets its KV blocks reserved
up front, so a request never burns its share of the packed compute pass
only to fail ``write_prefill`` afterwards (the burn-then-requeue path).
A request whose blocks cannot be reserved right now simply stays queued
until decode completions return blocks; one that can *never* fit the
pool fails fast instead of deadlocking the queue.

Reservation-aware preemption (bounding TTFT tails)
--------------------------------------------------
Admission alone only *defers* the queue head, so under sustained
shortage a fully-reserved decode batch can starve it indefinitely. The
scheduler therefore tracks consecutive head-of-line reservation
failures (``note_head_stall``); once the head has stalled for
``preempt_after_iters`` iterations — and the engine's cold-run reclaim
found nothing to free — the engine preempts the victims the scheduler
selects (``select_victim``: *newest* decode requests first by default,
so the oldest in-flight work always keeps making progress; or
fewest-blocks-held / closest-to-done behind
``SchedulerConfig.victim_policy``), retrying
admission after each one until the head fits, and only then requeues
the victims at the queue front (``preempt_requeue``) so they keep
FCFS priority over everything still waiting — held back until the
head admits, their freed blocks accumulate toward the head's
shortfall instead of being re-reserved by a front-requeued victim. Preemptions are counted separately from retries — the bounded
``retry_limit`` keeps governing genuine failures — and a request
preempted ``preempt_limit`` times becomes ineligible for further
victim selection (liveness guard: two requests ping-ponging over a
one-request pool must eventually fall back to plain FIFO).
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

from repro_torch.serving.request import Request, State


@dataclass
class SchedulerConfig:
    max_batch_tokens: int = 150_000     # ORCA budget (paper uses 150k)
    max_decode_batch: int = 16
    max_queue: int = 1024
    deadline_s: float = 0.0             # 0 = no deadline (straggler guard)
    retry_limit: int = 2
    max_prefill_batch: int = 4          # prefills packed per iteration
    # reservation-aware preemption: preempt the newest decode request
    # once one queue head accumulated this many reservation-failure
    # iterations (0 = preemption disabled; non-failure deferrals
    # neither count nor reset — see note_head_stall). ``preempt_limit``
    # caps how often one request may be chosen as victim (liveness).
    preempt_after_iters: int = 0
    preempt_limit: int = 2
    # victim policy: "newest" (default — oldest in-flight work keeps
    # progressing), "fewest-blocks" (smallest pool footprint first —
    # table blocks plus open reservation — minimizing discarded work
    # per preemption), or "closest-to-done" (fewest remaining output
    # tokens first — the victim that would have freed its blocks
    # soonest anyway loses the least runway); ties break newest-first
    victim_policy: str = "newest"
    # queue-driven look-ahead prefetch: each engine iteration, tier
    # promotions are (re)issued for the first N queued requests —
    # requests deep in the queue do not pollute the HBM tier, and a
    # request that advances toward the head gets its chunk caches
    # promoted while it still has queue wait left to hide the load
    # (§3.5; replaces the old enqueue-time-only prefetch)
    prefetch_lookahead: int = 4


class Scheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = deque()
        self.retries: dict[int, int] = {}
        self.preemptions: dict[int, int] = {}  # rid -> times preempted
        self._stall_rid: Optional[int] = None  # head whose stall we count
        self._stall_iters = 0

    def enqueue(self, req: Request, clock: float) -> bool:
        if len(self.queue) >= self.cfg.max_queue:
            req.state = State.FAILED
            self.on_terminal(req)
            return False
        req.t_enqueued = clock
        req.state = State.QUEUED
        self.queue.append(req)
        return True

    def requeue(self, req: Request) -> bool:
        """Straggler/failure mitigation: bounded re-dispatch."""
        n = self.retries.get(req.rid, 0) + 1
        self.retries[req.rid] = n
        if n > self.cfg.retry_limit:
            req.state = State.FAILED
            self.on_terminal(req)
            return False
        req.state = State.QUEUED
        self.queue.appendleft(req)
        return True

    def on_terminal(self, req: Request):
        """Drop per-request bookkeeping once a request reaches a terminal
        state (DONE/FAILED). Without this the ``retries`` dict grows
        without bound on long-running engines — one entry per request
        that was ever requeued."""
        self.retries.pop(req.rid, None)
        self.preemptions.pop(req.rid, None)
        if req.prefetch_ticket is not None:
            # a terminal request's pending tier promotions are garbage:
            # retract them (the fail-fast admission paths end here
            # without passing through the engine's teardown)
            req.prefetch_ticket.cancel()
            req.prefetch_ticket = None
        if self._stall_rid == req.rid:
            self.note_head_progress()

    # ---- reservation-aware preemption --------------------------------------
    def note_head_stall(self, rid: int) -> int:
        """Record one iteration in which the queue head failed to
        reserve its blocks. The counter is keyed to the head's rid so a
        new head starts from zero; iterations where the head is
        deferred for other reasons (ORCA budget, decode cap) neither
        count nor reset it — only an admission (``note_head_progress``)
        or a head change does, so budget churn cannot defeat the
        threshold. Returns the accumulated stall count."""
        if self._stall_rid != rid:
            self._stall_rid = rid
            self._stall_iters = 0
        self._stall_iters += 1
        return self._stall_iters

    def note_head_progress(self):
        """The head was admitted (or changed for another reason):
        reset the stall tracker."""
        self._stall_rid = None
        self._stall_iters = 0

    def should_preempt(self) -> bool:
        """Preemption policy: fire once the head has stalled on
        reservation for ``preempt_after_iters`` consecutive iterations
        (0 disables preemption entirely)."""
        return (self.cfg.preempt_after_iters > 0
                and self._stall_iters >= self.cfg.preempt_after_iters)

    def select_victim(self, decoding: List[Request]) -> Optional[Request]:
        """Victim selection hook, governed by ``cfg.victim_policy``:

        ``newest`` (default): the newest decode request — the oldest
        in-flight work keeps progressing, which is what guarantees
        liveness. ``fewest-blocks``: the request holding the fewest
        pool blocks (table blocks plus any open reservation's), so
        each preemption discards the least completed work.
        ``closest-to-done``: the request with the fewest remaining
        output tokens — it would have freed its blocks soonest anyway,
        so preempting it costs the least forward runway (and its
        re-decode after requeue is the shortest). All ties break
        newest-first. Either way, requests already preempted
        ``preempt_limit`` times are skipped (a pool that fits one
        request would otherwise ping-pong two requests forever)."""
        eligible = [r for r in reversed(decoding)
                    if self.preemptions.get(r.rid, 0)
                    < self.cfg.preempt_limit]
        if not eligible:
            return None
        if self.cfg.victim_policy == "fewest-blocks":
            # min() is stable, and eligible is newest-first
            return min(eligible, key=self._blocks_held)
        if self.cfg.victim_policy == "closest-to-done":
            return min(eligible, key=self._tokens_remaining)
        return eligible[0]

    @staticmethod
    def _tokens_remaining(req: Request) -> int:
        """Output tokens a decode request still owes (its remaining
        pool tenure, in steps)."""
        return req.max_new_tokens - len(req.output_tokens)

    @staticmethod
    def _blocks_held(req: Request) -> int:
        """Pool blocks a decode request pins: its table's, plus an open
        reservation's undrawn tail (both return to the pool on
        preemption teardown)."""
        held = len(req.table.blocks) if req.table is not None else 0
        res = req.reservation
        if res is not None and not res.closed:
            held += res.remaining
        return held

    def preempt_requeue(self, req: Request):
        """Return a preempted request to the *front* of the queue: it
        keeps FCFS priority over everything still waiting (the starved
        head was already re-admitted by the engine before this call).
        Counted separately from ``retries`` so the bounded
        ``retry_limit`` keeps governing genuine failures — and the
        rid's retry debt is cleared: the engine *chose* to discard the
        attempt, so burns the preemption churn caused (e.g. a delta
        write-back whose ``reserve_full`` escalation the preemption
        reset) must not accumulate across preemption cycles into a
        FAILED state. Within one serving lifecycle ``retry_limit``
        still bounds retries, and ``preempt_limit`` bounds how many
        lifecycles preemption can open."""
        self.preemptions[req.rid] = self.preemptions.get(req.rid, 0) + 1
        self.retries.pop(req.rid, None)
        req.state = State.QUEUED
        self.queue.appendleft(req)
        self.note_head_progress()

    # ---- queue-driven look-ahead prefetch -----------------------------------
    def prefetch_targets(self) -> List[Request]:
        """Queued requests within the look-ahead window whose tier
        prefetches have not been issued yet (each is marked issued so
        one request prefetches once per attempt; ``reset_attempt``
        re-arms). The engine issues the actual store prefetches —
        scheduling stays storage-agnostic."""
        out: List[Request] = []
        for req in itertools.islice(self.queue,
                                    self.cfg.prefetch_lookahead):
            if not req.prefetch_issued:
                req.prefetch_issued = True
                out.append(req)
        return out

    @staticmethod
    def _need(req: Request) -> int:
        return (len(req.system_tokens) +
                sum(len(c) for c in req.chunk_tokens) +
                len(req.question_tokens) + req.max_new_tokens)

    def next_prefills(self, decode_tokens_in_flight: int,
                      decode_batch_size: int, *,
                      pool=None,
                      reserve_blocks_fn=None,
                      free_tokens: Optional[int] = None,
                      block_size: int = 1,
                      limit: Optional[int] = None) -> List[Request]:
        """Drain head-of-line requests for one packed prefill pass while
        the ORCA token budget and decode-batch capacity allow.

        With ``pool`` (a ``KVPool``), admission reserves blocks for
        *every* admitted request — ``req.reservation`` is populated and
        ``write_prefill``/``append_token`` draw from it — so admission
        can never over-commit the pool and the burn-compute-then-requeue
        path disappears. A head request that cannot reserve right now
        stays queued (blocks return as decode completes); one whose
        block need exceeds the whole pool fails through the bounded
        retry path so the queue cannot deadlock.

        ``reserve_blocks_fn(req) -> int`` overrides the block estimate
        (delta-only admission with zero-copy chunk sharing: segments
        covered by a pool-resident shared run reserve nothing, so
        admission headroom reflects true marginal cost and more
        requests pack per iteration under pool pressure). The ORCA
        token budget still counts full prompt tokens — shared keys
        occupy attention compute either way.

        Without ``pool``, the legacy headroom estimate applies:
        ``free_tokens`` bounds admissions *beyond the first* (the first
        admission is always attempted so the pool-exhaustion retry/fail
        path stays reachable), with each request's token need rounded up
        to ``block_size`` to match per-request block allocation."""
        cap = self.cfg.max_prefill_batch if limit is None \
            else min(limit, self.cfg.max_prefill_batch)
        out: List[Request] = []
        budget = decode_tokens_in_flight
        packed_blocks = 0
        while self.queue and len(out) < cap and \
                decode_batch_size + len(out) < self.cfg.max_decode_batch:
            need = self._need(self.queue[0])
            if need > self.cfg.max_batch_tokens:
                # larger than the whole ORCA budget: can never be
                # admitted, so fail fast instead of stalling the queue.
                # Deliberately NOT gated on ``pool`` — the storeless /
                # legacy path hits the same ``budget + need`` break
                # below and would otherwise livelock on an oversized
                # head forever
                req = self.queue.popleft()
                req.state = State.FAILED
                self.on_terminal(req)
                continue
            if budget + need > self.cfg.max_batch_tokens:
                break
            bsz = pool.block_size if pool is not None else block_size
            if pool is not None and reserve_blocks_fn is not None:
                blocks = reserve_blocks_fn(self.queue[0])
            else:
                blocks = -(-need // bsz)
            if pool is not None:
                if blocks > pool.num_blocks:
                    # can never fit: fail fast, keep the queue moving
                    req = self.queue.popleft()
                    req.state = State.FAILED
                    self.on_terminal(req)
                    continue
                res = pool.reserve(blocks)
                if res is None:
                    # the head stays queued; whether the shortage is
                    # recoverable (decode completions, cold-run
                    # reclaim, preemption) or terminal (leaked blocks
                    # -> the engine's shortage valve burns a bounded
                    # retry) is the engine's call — this loop cannot
                    # tell a reclaimable pinned run from a leak, and
                    # burning retries here while the engine was still
                    # recovering blocks used to FAIL servable requests
                    break
                req = self.queue.popleft()
                req.reservation = res
            else:
                if out and free_tokens is not None and \
                        (packed_blocks + blocks) * bsz > free_tokens:
                    break
                req = self.queue.popleft()
            out.append(req)
            budget += need
            packed_blocks += blocks
        return out

    def next_prefill(self, decode_tokens_in_flight: int,
                     decode_batch_size: int) -> Optional[Request]:
        """Single-admission spelling of ``next_prefills`` (limit=1)."""
        got = self.next_prefills(decode_tokens_in_flight,
                                 decode_batch_size, limit=1)
        return got[0] if got else None

    def expired(self, req: Request, clock: float) -> bool:
        """Straggler guard: a queued request whose total wait exceeded
        its deadline. ``Engine.step`` polls this every iteration and
        FAILs expired queued requests through the teardown path (the
        guard was dead code before that wiring — a documented deadline
        that never fired). A per-request ``Request.deadline_s`` (> 0,
        e.g. a tenant SLO from the mixed-tenant workload generator)
        overrides the scheduler-wide ``SchedulerConfig.deadline_s``."""
        deadline = req.deadline_s if req.deadline_s > 0 \
            else self.cfg.deadline_s
        return (deadline > 0 and req.t_enqueued is not None
                and clock - req.t_enqueued > deadline)

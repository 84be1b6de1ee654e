"""Request lifecycle for the serving engine."""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serving.kvpool import BlockTable, Reservation


class State(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"
    FAILED = "failed"
    # user-initiated cancellation (online serving): the request was torn
    # down through the same ``Engine._teardown`` path preemption and
    # expiry use — blocks freed, shared-run readers released, pending
    # tier promotions retracted — but unlike FAILED it is not an error
    # and unlike preemption it never re-enters the queue
    CANCELLED = "cancelled"


@dataclass
class Request:
    rid: int
    system_tokens: np.ndarray
    chunk_tokens: List[np.ndarray]
    question_tokens: np.ndarray
    max_new_tokens: int = 32
    arrival_time: float = 0.0            # workload clock (seconds)
    # --- multi-tenant / session identity (online serving) ---
    # tenant name for per-tenant SLO rollups (metrics.tenant_rollups);
    # deadline_s is this request's own queue-wait SLO — it overrides
    # the scheduler-wide ``SchedulerConfig.deadline_s`` when set (> 0)
    tenant: str = "default"
    deadline_s: float = 0.0
    # session-structured workloads: which conversation this request
    # belongs to and which turn it is (metadata only — the engine does
    # not interpret them; generators and benches do)
    session: int = -1
    turn: int = 0
    # --- engine state ---
    state: State = State.QUEUED
    table: BlockTable = field(default_factory=BlockTable)
    # KV blocks reserved at admission; the engine commits on completion
    # and cancels on requeue/failure
    reservation: Optional[Reservation] = None
    # zero-copy chunk sharing: canonical pool runs this request's table
    # references (reader refs released on terminal states / requeue)
    shared_runs: List = field(default_factory=list)
    # per-segment prompt hashes, computed once at submit (admission
    # estimates probe them on every scheduler attempt)
    prompt_hashes: Optional[List[str]] = None
    # escalation after a failed zero-copy write-back: the retry
    # reserves the full block need and writes back copy-style, so a
    # delta estimate that under-budgeted CoW clones cannot FAIL a
    # request the copy path would serve
    reserve_full: bool = False
    # queue-driven look-ahead prefetch: set when the scheduler window
    # reached this request and the engine issued its tier promotions;
    # the ticket retracts promotions still pending when the request is
    # torn down (expiry/preemption/requeue) before they were served
    prefetch_issued: bool = False
    prefetch_ticket: Optional[object] = None
    output_tokens: List[int] = field(default_factory=list)
    # high-water mark of output indices already handed to
    # ``Engine.drain_tokens`` subscribers. Survives ``reset_attempt``:
    # a requeued/preempted attempt re-prefills and recomputes the same
    # token prefix, and a live stream must not receive those indices a
    # second time (``Engine._emit_token`` gates on this)
    tokens_emitted: int = 0
    total_len: int = 0
    # --- timings ---
    t_enqueued: Optional[float] = None
    # first time ANY attempt entered a prefill pass. Unlike
    # ``t_prefill_start`` this survives ``reset_attempt``: it dates the
    # head-of-line wait (``queue_wait``) — a preempted request was
    # already served once, so its requeue must not re-open that clock
    t_first_service: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # --- counters ---
    # blocks the delta-aware admission estimate skipped vs a full
    # per-request reservation (set by the engine's estimator, rolled
    # into ServingCounters.delta_blocks_saved on admission)
    delta_blocks_saved: int = 0
    prefill_tokens_computed: int = 0
    prefill_tokens_total: int = 0
    cache_hits: int = 0
    load_seconds_modeled: float = 0.0
    # set by the engine's straggler guard when this request FAILED
    # because its (per-request or scheduler-wide) deadline expired —
    # distinguishes SLO misses from genuine failures in the per-tenant
    # rollups
    deadline_hit: bool = False

    def reset_attempt(self):
        """Clear attempt-scoped state before the request re-enters the
        queue (requeue after a failed write-back, or preemption).

        Arrival identity — ``rid``, ``arrival_time``, ``t_enqueued``,
        ``prompt_hashes`` — survives: TTFT/queue-wait metrics must
        measure from the original enqueue, not the retry. Everything a
        single prefill+decode attempt produced is dropped: without
        this, a requeued request reported ``t_first_token`` /
        ``t_prefill_start`` / ``prefill_tokens_*`` / ``cache_hits``
        from the burned attempt (stale-metrics bug), and stale
        ``output_tokens`` would terminate the retry early with a
        corrupted output sequence. ``reserve_full`` is attempt-spanning
        escalation state and is managed by the caller (the engine
        resets it on preemption, sets it on write-back burns).
        ``tokens_emitted`` also spans attempts: it tracks what a
        stream consumer has already seen, which a retry must not
        replay."""
        self.output_tokens = []
        self.total_len = 0
        self.prefetch_issued = False     # a fresh attempt re-prefetches
        self.prefetch_ticket = None
        self.t_prefill_start = None
        self.t_first_token = None
        self.prefill_tokens_computed = 0
        self.prefill_tokens_total = 0
        self.cache_hits = 0
        self.load_seconds_modeled = 0.0
        self.delta_blocks_saved = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None or self.t_enqueued is None:
            return None
        return self.t_first_token - self.t_enqueued

    @property
    def queue_wait(self) -> Optional[float]:
        """Head-of-line wait: enqueue to first service (the first
        attempt's prefill start) — the tail the preemption subsystem
        bounds. Preemption re-queues a request *after* it was served,
        so later attempts do not re-open this clock."""
        if self.t_first_service is None or self.t_enqueued is None:
            return None
        return self.t_first_service - self.t_enqueued

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.t_done is None or self.t_enqueued is None:
            return None
        return self.t_done - self.t_enqueued

    @property
    def finished(self) -> bool:
        return self.state in (State.DONE, State.FAILED, State.CANCELLED)

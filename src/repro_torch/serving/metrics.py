"""Quality metrics (paper §5.1.3): ROUGE-L F1 and Jaccard similarity over
token sequences, plus deviation measures used in Figs. 7/12/15, the
serving-side counters (reservation protocol + incremental decode batch)
shared by the pool, the engine, and the Fig. 22 benches, and the
per-tenant SLO rollups (``tenant_rollups``) the online server's
``/stats`` endpoint reports."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np


@dataclass
class ServingCounters:
    """Shared event counters for the serving layer.

    One instance is threaded through ``Engine`` -> ``KVPool`` so
    reservation-protocol events (pool) and decode-batch maintenance
    events (engine) land in one place; benches and tests assert on it
    directly (e.g. zero ``burn_requeues`` under reservation, membership
    changes absorbed without ``decode_rebuilds``)."""
    # --- KV reservation protocol (reserve-at-admission) ---
    reservations_made: int = 0
    reservations_committed: int = 0
    reservations_cancelled: int = 0
    reserve_failures: int = 0            # admissions deferred for headroom
    blocks_reserved_peak: int = 0
    blocks_reserved_total: int = 0       # sum of all reservation sizes
    # --- delta-only admission (zero-copy chunk sharing) ---
    delta_blocks_saved: int = 0          # full-estimate minus reserved
    # --- zero-copy shared chunk blocks (pin/share/CoW/unpin) ---
    shared_seg_hits: int = 0             # hit segments attached zero-copy
    shared_runs_materialized: int = 0    # canonical runs pinned into pool
    shared_block_refs: int = 0           # block references added by shares
    shared_blocks_peak: int = 0          # max blocks with refcount > 1
    live_blocks_peak: int = 0            # max blocks with refcount > 0
    cow_clones: int = 0                  # copy-on-write block splits
    run_unpins: int = 0                  # canonical runs released
    run_unpins_deferred: int = 0         # evictions that waited on readers
    run_reclaims: int = 0                # zero-reader runs unpinned under
    #     pool pressure (admission backpressure)
    # --- packed prefill admission ---
    burn_requeues: int = 0               # computed a prefill, then failed
    #     the KV write-back and requeued. Stays 0 on the copy path with
    #     reservations on; the zero-copy path may burn at most once per
    #     pressured request (delta estimates do not budget CoW clones)
    #     before the retry escalates to a full reservation
    # --- reservation-aware preemption (TTFT tail bounding) ---
    preemptions: int = 0                 # decode requests preempted for a
    #     starved queue head (requeued at the front, not a retry)
    preempt_block_recovered: int = 0     # pool blocks freed by preemption
    #     teardowns (table refs + cancelled reservation + deferred unpins)
    head_stall_iters_max: int = 0        # longest run of consecutive
    #     iterations one queue head failed to reserve (count-based
    #     stand-in for the head-of-line wait tail: preemption bounds it
    #     near preempt_after_iters, deferral lets it run to decode drain)
    deadline_expired: int = 0            # queued requests FAILed by the
    #     straggler guard (SchedulerConfig.deadline_s)
    # --- queue-driven look-ahead prefetch + layer-granular streaming ---
    prefetch_issued: int = 0             # requests whose tier promotions
    #     were issued by the scheduler's look-ahead window
    prefetch_cancels: int = 0            # tickets retracted at teardown
    #     (expiry/preemption/requeue before the promotions were served)
    preload_layers_blocked: int = 0      # per-layer awaits that waited
    preload_layers_hidden: int = 0       # per-layer loads fully hidden
    #     behind earlier windows' compute (streamed prefill)
    # --- tensor-parallel serving (sharded attention backend) ---
    attn_flops_total: int = 0            # analytic attention FLOPs issued
    #     (4*Tq*Tk*H*D per layer, padded shapes; count-based so the CI
    #     sharded-smoke gate is timing-immune)
    attn_flops_device: int = 0           # per-device share of the above
    #     (total / kv_shards; strictly below total on a real mesh)
    # --- incremental decode batch ---
    decode_rebuilds: int = 0             # full (B, S) gather rebuilds
    #     (paged mode: (B, S) re-buckets of the index tensor — no KV
    #     is gathered, see decode_gather_bytes)
    decode_joins: int = 0                # requests written into a free row
    decode_leaves: int = 0               # rows masked (pos = -1) on exit
    decode_rows_recycled: int = 0        # masked rows reused by a join
    # --- paged decode (block-table-native attention) ---
    decode_gather_bytes: int = 0         # KV bytes copied out of the pool
    #     to build/maintain the arena decode batch (rebuild gathers +
    #     join gathers). The paged path reads KV in place through slot
    #     index rows, so this stays ~0 there — the Fig. 22 paged lane
    #     gates on it
    decode_join_copies: int = 0          # joins that copied KV into a
    #     batch row (arena in-place joins); paged joins are row-map
    #     updates and count 0 here
    paged_block_syncs: int = 0           # dirty pool blocks uploaded into
    #     the device twin (host writes: prefill write-back, CoW clones,
    #     recompute fixups) before a paged step
    paged_sync_bytes: int = 0            # KV bytes those uploads moved —
    #     the honest block-granular transfer cost the paged layout pays
    #     instead of per-step whole-request gathers

    def reset(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def stats_dict(self) -> dict:
        """The one exported counter payload: every counter by name.
        The server's ``/stats`` endpoint serves it verbatim and the
        Fig. 22 benches index into it instead of hand-picking
        attributes (one schema, one source of truth)."""
        return dataclasses.asdict(self)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (inclusive, numpy 'lower' flavor is too
    optimistic for tail latencies with few samples). Empty input -> 0."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return 0.0
    rank = max(1, int(np.ceil(q / 100.0 * len(xs))))
    return xs[rank - 1]


def ttft_p99(requests) -> float:
    """p99 time-to-first-token over the requests that produced one
    (the tail the preemption subsystem bounds, Fig. 22)."""
    return percentile([r.ttft for r in requests if r.ttft is not None], 99)


def queue_wait_p99(requests) -> float:
    """p99 head-of-line wait (enqueue -> serving prefill start)."""
    return percentile([r.queue_wait for r in requests
                       if r.queue_wait is not None], 99)


def tenant_rollups(requests) -> Dict[str, dict]:
    """Per-tenant SLO rollups over a set of (possibly in-flight)
    requests: TTFT p99, queue-wait p99, terminal-state counts, and how
    many of the failures were deadline (SLO) expiries. This is the
    payload the online server reports under ``/stats`` ``tenants`` and
    the serve CI gate asserts on — mixed-tenant traces with per-tenant
    deadlines (``Request.tenant`` / ``Request.deadline_s``) land here.
    """
    from repro_torch.serving.request import State
    by: Dict[str, dict] = {}
    for r in requests:
        d = by.setdefault(r.tenant, dict(
            requests=0, completed=0, failed=0, cancelled=0,
            deadline_expired=0, ttft_p99_s=[], queue_wait_p99_s=[]))
        d["requests"] += 1
        d["completed"] += r.state == State.DONE
        d["failed"] += r.state == State.FAILED
        d["cancelled"] += r.state == State.CANCELLED
        d["deadline_expired"] += r.deadline_hit
        if r.ttft is not None:
            d["ttft_p99_s"].append(r.ttft)
        if r.queue_wait is not None:
            d["queue_wait_p99_s"].append(r.queue_wait)
    for d in by.values():
        d["ttft_p99_s"] = percentile(d["ttft_p99_s"], 99)
        d["queue_wait_p99_s"] = percentile(d["queue_wait_p99_s"], 99)
    return by


def _lcs(a: Sequence[int], b: Sequence[int]) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    prev = np.zeros(n + 1, np.int32)
    for i in range(1, m + 1):
        cur = np.zeros(n + 1, np.int32)
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else \
                max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[n])


def rouge_l_f1(candidate: Sequence[int], reference: Sequence[int]) -> float:
    l = _lcs(list(candidate), list(reference))
    if l == 0:
        return 0.0
    p = l / len(candidate)
    r = l / len(reference)
    return 2 * p * r / (p + r)


def jaccard(candidate: Sequence[int], reference: Sequence[int]) -> float:
    a, b = set(candidate), set(reference)
    if not a and not b:
        return 1.0
    return len(a & b) / max(1, len(a | b))


def token_agreement(candidate: Sequence[int],
                    reference: Sequence[int]) -> float:
    n = min(len(candidate), len(reference))
    if n == 0:
        return 0.0
    return float(np.mean([candidate[i] == reference[i] for i in range(n)]))


def relative_deviation(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))

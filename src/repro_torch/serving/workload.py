"""Workload generation: Poisson arrivals at a target QPM over a session-
structured RAG trace (paper §5.3 uses Twitter-derived traces; we expose
the same QPM knob).

Session structure (online-serving workloads):

* every session has its OWN system prefix (drawn from a per-session
  spawned rng — the old generator reused one ``sys_tokens`` array
  object across all requests, so cross-session "reuse" of the system
  segment was an artifact, not workload structure);
* with ``turns > 1`` a session is a multi-turn conversation: each
  turn's prefix grows by the session's accumulated history (previous
  turns' questions), and the retrieved chunk list is deterministically
  ROTATED by the turn index — the same chunks reappear at different
  positions, exercising reordered-context reuse (the RoPE/causality
  fixup path) instead of only prefix-identical hits;
* ``tenants`` assigns each session to a named tenant (weighted,
  deterministic per session) carrying a per-request deadline and
  output budget — the mixed-tenant traces the per-tenant SLO rollups
  (``metrics.tenant_rollups``) and the serve CI gate consume.

Determinism contract: all new structure draws from rngs spawned off
``(seed, session)`` keys, never from the main arrival rng — a
single-turn, single-tenant config consumes the main rng stream exactly
as the pre-session generator did, so tuned scenarios (pool sizes that
force preemption, admission-pressure tests) replay unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.rag import KnowledgeBase, Retriever, make_question
from repro_torch.serving.request import Request


@dataclass(frozen=True)
class TenantSpec:
    """One tenant in a mixed trace: selection weight, the per-request
    queue-wait SLO its requests carry (``Request.deadline_s``; 0 means
    no per-tenant deadline), and an optional output-length budget."""
    name: str
    weight: float = 1.0
    deadline_s: float = 0.0
    max_new_tokens: Optional[int] = None


@dataclass
class WorkloadConfig:
    num_requests: int = 50
    qpm: float = 60.0                  # queries per minute
    k_chunks: int = 5
    sys_len: int = 8
    question_len: int = 12
    max_new_tokens: int = 16
    zipf_a: float = 1.2
    sessions: int = 8                  # session reuse (same retrieval seed)
    seed: int = 0
    # --- session structure (defaults preserve the single-turn trace) ---
    turns: int = 1                     # >1: multi-turn conversations
    history_max: int = 48              # cap on accumulated history tokens
    tenants: Optional[Sequence[TenantSpec]] = None


def _session_prefix(wcfg: WorkloadConfig, vocab: int,
                    session: int) -> np.ndarray:
    """Independent per-session system prefix, keyed off (seed, session)
    so it never consumes the main arrival rng."""
    r = np.random.default_rng([wcfg.seed, 7, session])
    return r.integers(0, vocab, wcfg.sys_len).astype(np.int32)


def _session_tenant(wcfg: WorkloadConfig, session: int) -> TenantSpec:
    """Deterministic weighted tenant assignment per session."""
    ts = list(wcfg.tenants)
    w = np.array([t.weight for t in ts], np.float64)
    r = np.random.default_rng([wcfg.seed, 11, session])
    return ts[int(r.choice(len(ts), p=w / w.sum()))]


def generate(kb: KnowledgeBase, wcfg: WorkloadConfig) -> List[Request]:
    rng = np.random.default_rng(wcfg.seed)
    retr = Retriever(kb, k=wcfg.k_chunks, zipf_a=wcfg.zipf_a,
                     seed=wcfg.seed)
    # kept (and intentionally unused): the pre-session generator drew a
    # single shared prefix here; consuming the same draws keeps every
    # later arrival/retrieval/question draw on the identical stream
    rng.integers(0, kb.vocab_size, wcfg.sys_len)
    turn_of: Dict[int, int] = {}
    history: Dict[int, List[np.ndarray]] = {}
    t = 0.0
    reqs: List[Request] = []
    for i in range(wcfg.num_requests):
        t += rng.exponential(60.0 / wcfg.qpm)
        session = int(rng.integers(0, wcfg.sessions))
        # session-correlated retrieval: queries in a session share a seed
        # base, mimicking within-session chunk reuse (§2.3: 55% in-session)
        qseed = session * 1000 + int(rng.integers(0, 6))
        ids = retr.retrieve(qseed)
        turn = turn_of.get(session, 0)
        if wcfg.turns > 1:
            turn_of[session] = (turn + 1) % wcfg.turns
            # same chunks, different positions: rotate by turn so later
            # turns re-hit cached chunks at shifted offsets
            rot = turn % len(ids)
            ids = ids[rot:] + ids[:rot]
        q = make_question(rng, kb, ids, wcfg.question_len)
        sys_tokens = _session_prefix(wcfg, kb.vocab_size, session)
        if wcfg.turns > 1:
            hist = history.setdefault(session, [])
            if turn > 0 and hist:
                grown = np.concatenate([sys_tokens] + hist)
                sys_tokens = grown[:wcfg.sys_len + wcfg.history_max]
            hist.append(q)
        tenant, deadline, max_new = "default", 0.0, wcfg.max_new_tokens
        if wcfg.tenants:
            ts = _session_tenant(wcfg, session)
            tenant, deadline = ts.name, ts.deadline_s
            if ts.max_new_tokens is not None:
                max_new = ts.max_new_tokens
        reqs.append(Request(
            rid=i, system_tokens=sys_tokens,
            chunk_tokens=retr.chunks_for(ids), question_tokens=q,
            max_new_tokens=max_new, arrival_time=t,
            tenant=tenant, deadline_s=deadline,
            session=session, turn=turn))
    return reqs

"""Traffic generator: one general generator over the parameters of a
traffic file (``traffic/<name>.json``).

Frozen copy, vectorised, of the port's RAG substrate and workload
generator (``src/repro_torch/serving/rag.py``, ``serving/workload.py``):
a knowledge base of token chunks, sessions with their own system prefix,
Zipf-popular top-k retrieval, turns that rotate the retrieved chunks, and
questions that copy 4-grams of the retrieved chunks.

Every seed gets the same work in the same order: the structure of the
trace (sessions, retrieval sets, the chunks' lengths, the output lengths
and the inter-arrival gaps, each a fixed multiset in an order drawn once)
comes from ``structure_seed`` of the traffic file, and ``--seed`` draws
the tokens (and the benchmark's weights). Near the knee the order of the
arrivals moves the tails far more than two runs of one order differ, so
the order is part of the traffic, not of the seed.

Kinds: ``open_loop`` (Poisson arrivals at ``rate_per_s``, each request due
at a fixed time) and ``closed_loop`` (``clients`` that each send their next
request when the last one is done).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Req:
    idx: int                       # index in the trace
    session: int
    system: np.ndarray
    chunks: List[np.ndarray]
    chunk_ids: List[int]
    question: np.ndarray
    max_new: int
    due: Optional[float] = None    # open loop: seconds after window start

    @property
    def prompt_len(self) -> int:
        return len(self.system) + sum(len(c) for c in self.chunks) + \
            len(self.question)


def stratified(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]: the same multiset for every
    seed (the midpoints of n equal slices of the range)."""
    if n <= 0:
        return np.zeros(0, np.int64)
    q = (np.arange(n) + 0.5) / n
    return np.rint(lo + (hi - lo) * q).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """The n quantile midpoints of Exp(rate): a fixed multiset of Poisson
    inter-arrival gaps."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def _tokens(rng: np.random.Generator, vocab: int, lengths) -> List[np.ndarray]:
    lengths = np.asarray(lengths, np.int64)
    flat = rng.integers(0, vocab, int(lengths.sum()), dtype=np.int64)
    return [a.astype(np.int32) for a in
            np.split(flat, np.cumsum(lengths)[:-1])] if len(lengths) else []


def _zipf_sets(rs: np.random.Generator, n_sets: int, k: int, n: int,
               a: float) -> np.ndarray:
    """[n_sets, k] distinct popularity ranks per set, P(rank r) ~ r^-a."""
    p = np.arange(1, n + 1, dtype=np.float64) ** (-a)
    p /= p.sum()
    out = np.zeros((n_sets, k), np.int64)
    for s in range(n_sets):
        g = rs.gumbel(size=n) + np.log(p)          # Gumbel top-k: without
        out[s] = np.argsort(-g, kind="stable")[:k]  # replacement, by p
    return out


class Trace:
    """The requests of one run: ``warmup`` (served in set-up) and
    ``window`` (open loop: due in the window; closed loop: the pool the
    clients draw from in order)."""

    def __init__(self, p: Dict, seed: int, vocab: int, seconds: float):
        self.p = p
        self.kind = p["kind"]
        rng = np.random.default_rng([seed, 101])
        rs = np.random.default_rng([int(p["structure_seed"]), 202])
        k = int(p["k"])
        sessions = int(p["sessions"])
        n_warm = int(p["warmup_requests"])
        if self.kind == "open_loop":
            rate = float(p["rate_per_s"])
            n_win = max(1, int(np.floor(rate * seconds)))
            gaps = rs.permutation(exp_gaps(rate, n_win))
            dues = np.cumsum(gaps)
            dues *= min(1.0, seconds / dues[-1] * 0.999)
        elif self.kind == "closed_loop":
            n_win = int(p["clients"]) * int(p["requests_per_client"])
            dues = None
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        n_all = n_warm + n_win
        self.sys_prefix = _tokens(rng, vocab, [int(p["sys_len"])] * sessions)
        lo, hi = p["chunk_len"]
        fresh = bool(p.get("fresh_chunks", False))
        n_chunks = n_all * k if fresh else int(p["kb_chunks"])
        lengths = rs.permutation(stratified(int(lo), int(hi), n_chunks))
        self.kb = _tokens(rng, vocab, lengths)
        olo, ohi = p["output_len"]
        outs = rs.permutation(stratified(int(olo), int(ohi), n_all))
        sess = rs.integers(0, sessions, n_all)
        turns = int(p.get("turns", 1))
        if fresh:
            ids_all = rs.permutation(n_chunks).reshape(n_all, k)
        else:
            q_per = int(p.get("queries_per_session", 6))
            sets = _zipf_sets(rs, sessions * q_per, k, n_chunks,
                              float(p["zipf_a"]))
            which = rs.integers(0, q_per, n_all)
            rank_to_chunk = rs.permutation(n_chunks)
            ids_all = rank_to_chunk[sets[sess * q_per + which]]
        turn_of = np.zeros(sessions, np.int64)
        qlen = int(p["question_len"])
        self.requests: List[Req] = []
        for i in range(n_all):
            s = int(sess[i])
            ids = [int(c) for c in ids_all[i]]
            if turns > 1 and not fresh:
                rot = int(turn_of[s]) % k
                ids = ids[rot:] + ids[:rot]
                turn_of[s] = (turn_of[s] + 1) % turns
            self.requests.append(Req(
                idx=i, session=s, system=self.sys_prefix[s],
                chunks=[self.kb[c] for c in ids], chunk_ids=ids,
                question=self._question(rng, ids, qlen, vocab),
                max_new=int(outs[i])))
        self.warmup = self.requests[:n_warm]
        self.window = self.requests[n_warm:]
        if dues is not None:
            for r, d in zip(self.window, dues):
                r.due = float(d)

    def _question(self, rng, ids, length, vocab) -> np.ndarray:
        """Copies a 4-gram from each of half the retrieved chunks, then
        pads with random tokens (``rag.make_question``)."""
        pick = rng.permutation(len(ids))[:max(1, len(ids) // 2)]
        parts = []
        for f in pick:
            c = self.kb[ids[f]]
            s = int(rng.integers(0, max(1, len(c) - 4)))
            parts.append(c[s:s + 4])
        q = np.concatenate(parts)[:length]
        pad = rng.integers(0, vocab, length - len(q))
        return np.concatenate([q, pad]).astype(np.int32)

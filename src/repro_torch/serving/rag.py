"""Synthetic RAG substrate: knowledge base, retriever, and question
generation with the reuse statistics the paper characterizes (Figs. 3/5/6:
Zipf-like chunk popularity, per-question top-k retrieval, cross-session
reuse)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class KnowledgeBase:
    """Token chunks standing in for the document store. A light Markov
    generator gives chunks internal n-gram structure so trained tiny
    models develop the intra>inter attention locality real LMs show."""
    num_chunks: int
    vocab_size: int
    chunk_len_min: int = 24
    chunk_len_max: int = 48
    seed: int = 0
    chunks: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # shared Markov transition skeleton (sparse, strongly local)
        nxt = rng.integers(0, self.vocab_size,
                           (self.vocab_size, 4)).astype(np.int32)
        for _ in range(self.num_chunks):
            n = int(rng.integers(self.chunk_len_min, self.chunk_len_max + 1))
            t = np.zeros(n, np.int32)
            t[0] = rng.integers(0, self.vocab_size)
            for i in range(1, n):
                if rng.random() < 0.8:
                    t[i] = nxt[t[i - 1], rng.integers(0, 4)]
                else:
                    t[i] = rng.integers(0, self.vocab_size)
            self.chunks.append(t)

    def sample_sequence(self, rng: np.random.Generator,
                        length: int) -> np.ndarray:
        """Training-data sampler with the same statistics."""
        parts = []
        total = 0
        while total < length:
            c = self.chunks[int(rng.integers(0, self.num_chunks))]
            parts.append(c)
            total += len(c)
        return np.concatenate(parts)[:length]


class Retriever:
    """Zipf-popularity retriever: a query draws top-k distinct chunks from
    a Zipf(a) distribution with query-dependent noise, reproducing the
    head-heavy retrieval-hit-rate CDF of Fig. 6a."""

    def __init__(self, kb: KnowledgeBase, k: int = 5, zipf_a: float = 1.2,
                 seed: int = 0):
        self.kb = kb
        self.k = k
        ranks = np.arange(1, kb.num_chunks + 1, dtype=np.float64)
        self.popularity = ranks ** (-zipf_a)
        self.popularity /= self.popularity.sum()
        self.rng = np.random.default_rng(seed)
        self.perm = self.rng.permutation(kb.num_chunks)

    def retrieve(self, query_seed: int) -> List[int]:
        rng = np.random.default_rng(query_seed)
        ids: List[int] = []
        while len(ids) < self.k:
            c = int(self.perm[rng.choice(self.kb.num_chunks,
                                         p=self.popularity)])
            if c not in ids:
                ids.append(c)
        return ids

    def chunks_for(self, ids: Sequence[int]) -> List[np.ndarray]:
        return [self.kb.chunks[i] for i in ids]


def make_question(rng: np.random.Generator, kb: KnowledgeBase,
                  chunk_ids: Sequence[int], length: int = 12) -> np.ndarray:
    """Question tokens that reference (copy n-grams from) a subset of the
    retrieved chunks so question->chunk attention is informative."""
    focus = rng.choice(len(chunk_ids), size=max(1, len(chunk_ids) // 2),
                       replace=False)
    parts = []
    for f in focus:
        c = kb.chunks[chunk_ids[f]]
        s = int(rng.integers(0, max(1, len(c) - 4)))
        parts.append(c[s:s + 4])
    q = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    if len(q) >= length:
        return q[:length].astype(np.int32)
    pad = rng.integers(0, kb.vocab_size, length - len(q))
    return np.concatenate([q, pad]).astype(np.int32)

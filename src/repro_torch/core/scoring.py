"""Cache-Craft reusability metrics (paper §3.1-§3.2).

All scores are derived from the per-row chunk-mass statistic emitted by
the attention layers (model stats tensor [L, B, T, C] — softmax mass each
query row spends on keys of each chunk id, summed over heads). This is
the streaming equivalent of summing attention weights from QK^T:

  inter_l(C_i, C_j)  (Eq. 3)  = sum of mass rows of C_i onto chunk j keys
  intra_l(C_i)       (Eq. 4)  = mass of C_i rows onto its own keys
  a, b               (Eq. 9)  = normalized external / internal influence
  CCI                (Eq. 11) = sigmoid(a_bar / b_bar)
  beta               (Eq. 6)  = prefix-overlap score from stored inter
  gamma              (Eq. 7)  = normalized Kendall-tau order penalty
  beta'              (Eq. 8)  = beta * (1 - gamma)
  CFO                (Eq. 12) = alpha * CCI * (1 - beta')
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def inter_matrix(stats: np.ndarray, q_chunk: np.ndarray,
                 num_chunks: int) -> np.ndarray:
    """stats [L, T, C] row mass, q_chunk [T] -> inter [L, C, C] where
    inter[l, i, j] = mass from chunk-i query rows onto chunk-j keys."""
    L, T, C = stats.shape
    out = np.zeros((L, num_chunks, num_chunks), np.float64)
    for i in range(num_chunks):
        rows = q_chunk == i
        if rows.any():
            out[:, i, :] = stats[:, rows, :num_chunks].sum(axis=1)
    return out


@dataclass
class ChunkScores:
    """Per-chunk attention summary captured when a chunk-cache is created."""
    chunk_index: int                 # position index i in the source layout
    length: int                      # |C_i| in tokens
    a_bar: float                     # Eq. 10
    b_bar: float
    cci: float                       # Eq. 11
    prefix_hashes: List[str] = field(default_factory=list)
    prefix_inter: List[float] = field(default_factory=list)  # per prefix chunk
    token_inter: np.ndarray = field(default_factory=lambda: np.zeros(0))
    token_total: np.ndarray | None = None   # H2O criterion (mass received)
    orig_start: int = 0              # position of the chunk when cached


def sigmoid(x: float) -> float:
    return float(1.0 / (1.0 + np.exp(-x)))


def chunk_scores(inter: np.ndarray, lengths: Sequence[int], i: int,
                 prefix_hashes: Sequence[str],
                 token_inter: np.ndarray,
                 token_total: np.ndarray | None = None,
                 orig_start: int = 0) -> ChunkScores:
    """inter [L, C, C]; lengths per chunk index; i = this chunk's index.
    prefix chunk indices are 0..i-1 (index 0 may be the system prompt —
    callers pass its pseudo-hash so beta accounting stays consistent)."""
    L = inter.shape[0]
    li = max(1, lengths[i])
    a_l = np.zeros(L)
    for j in range(i):
        lj = max(1, lengths[j])
        a_l += inter[:, i, j] / (li * lj)
    b_l = inter[:, i, i] / (li * li)
    a_bar = float(a_l.mean())
    b_bar = float(b_l.mean())
    cci = sigmoid(a_bar / max(b_bar, 1e-9))
    prefix_inter = [float(inter[:, i, j].sum()) for j in range(i)]
    return ChunkScores(chunk_index=i, length=lengths[i], a_bar=a_bar,
                       b_bar=b_bar, cci=cci,
                       prefix_hashes=list(prefix_hashes),
                       prefix_inter=prefix_inter,
                       token_inter=np.asarray(token_inter, np.float64),
                       token_total=(None if token_total is None else
                                    np.asarray(token_total, np.float64)),
                       orig_start=orig_start)


def beta_score(scores: ChunkScores, new_prefix_hashes: Sequence[str]) -> float:
    """Eq. 6: fraction of the cached chunk's external attention mass that
    is still present in the new prefix."""
    total = sum(scores.prefix_inter)
    if total <= 0:
        return 1.0
    new = set(new_prefix_hashes)
    kept = sum(w for h, w in zip(scores.prefix_hashes, scores.prefix_inter)
               if h in new)
    return float(kept / total)


def kendall_tau_distance(old_order: Sequence[str],
                         new_order: Sequence[str]) -> float:
    """Eq. 7: normalized number of discordant pairs among common chunks."""
    new_set = set(new_order)
    common = [h for h in old_order if h in new_set]
    m = len(common)
    if m < 2:
        return 0.0
    new_rank = {h: r for r, h in enumerate(new_order)}
    d = 0
    for x in range(m):
        for y in range(x + 1, m):
            if new_rank[common[x]] > new_rank[common[y]]:
                d += 1
    return float(d) / (m * (m - 1) / 2)


def beta_prime(scores: ChunkScores,
               new_prefix_hashes: Sequence[str]) -> float:
    """Eq. 8: order-penalized prefix overlap."""
    b = beta_score(scores, new_prefix_hashes)
    g = kendall_tau_distance(scores.prefix_hashes, new_prefix_hashes)
    return b * (1.0 - g)


def cfo(scores: ChunkScores, new_prefix_hashes: Sequence[str],
        alpha: float = 1.0) -> float:
    """Eq. 12: fraction of the chunk's tokens to recompute, clipped to 1."""
    bp = beta_prime(scores, new_prefix_hashes)
    return float(min(1.0, alpha * scores.cci * (1.0 - bp)))

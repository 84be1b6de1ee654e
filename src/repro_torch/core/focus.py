"""Algorithm 1: predicting focused chunks (paper §3.2.2).

Per layer, accumulate the question->chunk inter-attention, split the
sorted cumulative scores at the entropy-curvature maximum (a change-point
detector over the score gaps), and declare the top segment "focused".
When the focused set is stable for ``w`` consecutive layers, recomputation
for the unfocused chunks can stop at that layer (L*).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set

import numpy as np


@dataclass
class FocusResult:
    focused: Set[int]          # chunk indices deemed focused
    cutoff_layer: int          # L*: first layer after which recompute stops
    converged: bool


def _split_point(sorted_scores: np.ndarray) -> int:
    """Lines 5-9: change-point over the consecutive score gaps. The
    paper's entropy-curvature formulation reduces to locating the
    dominant gap in the sorted cumulative scores; we take
    i* = argmax(gap) directly (ties -> smaller focused set), which
    matches the illustrated behaviour (Fig. 16/17) and is robust for
    small k. Returns the size of the high ("focused") segment, >= 1."""
    k = len(sorted_scores)
    if k <= 1:
        return k
    diff = sorted_scores[:-1] - sorted_scores[1:]
    if diff.sum() <= 1e-12:
        return k                     # flat scores: everything is focused
    return int(np.argmax(diff)) + 1


class FocusTracker:
    """Incremental Algorithm 1 for windowed layer execution: feed one
    layer's question->chunk inter vector at a time; ``converged`` flips
    once the focused set is stable for w consecutive layers."""

    def __init__(self, num_chunks: int, w: int = 3):
        self.cinter = np.zeros(num_chunks)
        self.w = w
        self.history: List[frozenset] = []
        self.converged = False
        self.focused: Optional[Set[int]] = None
        self.cutoff_layer: Optional[int] = None

    def update(self, inter_layer: np.ndarray) -> bool:
        if self.converged:
            return True
        self.cinter = self.cinter + inter_layer
        order = np.argsort(-self.cinter, kind="stable")
        i_star = _split_point(self.cinter[order])
        focused = frozenset(int(c) for c in order[:i_star])
        self.history.append(focused)
        if len(self.history) >= self.w and \
                all(h == focused for h in self.history[-self.w:]):
            self.converged = True
            self.focused = set(focused)
            self.cutoff_layer = len(self.history) - 1
        return self.converged


def predict_focused_chunks(inter_layers: np.ndarray, w: int = 3,
                           num_chunks: Optional[int] = None) -> FocusResult:
    """inter_layers [L, k]: per-layer question->chunk inter attention.
    Mirrors Algorithm 1 with confidence window ``w``."""
    L, k = inter_layers.shape
    cinter = np.zeros(k)
    history: List[frozenset] = []
    for layer in range(L):
        cinter = cinter + inter_layers[layer]          # Eq. 15
        order = np.argsort(-cinter, kind="stable")
        i_star = _split_point(cinter[order])
        focused = frozenset(int(c) for c in order[:i_star])
        history.append(focused)
        if layer + 1 >= w and all(h == focused for h in history[-w:]):
            return FocusResult(set(focused), layer, True)
    return FocusResult(set(history[-1]) if history else set(range(k)),
                       L - 1, False)

"""Recomputation planning (§3.4.1): classify chunks into C_hit / C_miss,
score reusability, pick recompute tokens, and lay out the prompt.

Layout of a RAG prompt:  [system][chunk_1 ... chunk_k][question]
Stat chunk ids:          0        1 ... k              k+1

The system prompt is treated as chunk 0 under the same framework (the
paper's footnote: instructions are an always-repeated chunk).

Which tokens get recomputed — and what counts as a hit at all — is the
strategy layer's job (``core.strategies``): ``build_plan`` carries only
the strategy name, resolves it through the registry, and lays out
whatever decisions ``classify`` returns. Strategies that defer token
choice to the executor (``needs_deviation``) leave ``deferred=True``
decisions in the plan; the executor finalizes them and re-lays-out via
``layout_plan``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.chunkstore import ChunkStore, Variant, prompt_hashes


@dataclass
class Segment:
    stat_id: int                 # id in the stats tensor
    start: int
    end: int
    tokens: np.ndarray
    chash: Optional[str] = None  # None for the question segment

    @property
    def length(self) -> int:
        return self.end - self.start


@dataclass
class ChunkDecision:
    seg: Segment
    variant: Optional[Variant]          # None -> miss (compute from scratch)
    cfo: float = 1.0
    recompute_idx: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    # True while a deviation-probed strategy (blend) has not yet chosen
    # the recompute set; the executor clears it before running the plan
    deferred: bool = False

    @property
    def is_hit(self) -> bool:
        return self.variant is not None


@dataclass
class InferencePlan:
    segments: List[Segment]             # all segments incl. question
    decisions: List[ChunkDecision]      # one per cacheable segment
    question: Segment
    total_len: int
    active_positions: np.ndarray        # absolute positions of active tokens
    active_tokens: np.ndarray
    active_stat_ids: np.ndarray
    # bookkeeping
    num_cached_tokens: int = 0
    num_active_tokens: int = 0

    @property
    def recompute_fraction(self) -> float:
        """Fraction of *cacheable* (non-question) tokens recomputed."""
        cacheable = self.total_len - self.question.length
        active_cacheable = self.num_active_tokens - self.question.length
        return active_cacheable / max(1, cacheable)


def layout_plan(segments: List[Segment], decisions: List[ChunkDecision],
                question: Segment, total_len: int) -> InferencePlan:
    """Derive the active-token layout from a set of decisions. Split out
    of ``build_plan`` so the executor can re-lay-out a plan after
    finalizing deferred (deviation-probed) decisions."""
    act_pos, act_tok, act_sid = [], [], []
    cached_tokens = 0
    for d in decisions:
        if d.is_hit:
            cached_tokens += d.seg.length - len(d.recompute_idx)
            sel = d.recompute_idx
        else:
            sel = np.arange(d.seg.length)
        act_pos.append(d.seg.start + sel)
        act_tok.append(d.seg.tokens[sel])
        act_sid.append(np.full(len(sel), d.seg.stat_id))
    act_pos.append(np.arange(question.start, question.end))
    act_tok.append(question.tokens)
    act_sid.append(np.full(question.length, question.stat_id))

    active_positions = np.concatenate(act_pos).astype(np.int32)
    order = np.argsort(active_positions, kind="stable")
    return InferencePlan(
        segments=segments + [question], decisions=decisions,
        question=question, total_len=total_len,
        active_positions=active_positions[order],
        active_tokens=np.concatenate(act_tok).astype(np.int32)[order],
        active_stat_ids=np.concatenate(act_sid).astype(np.int32)[order],
        num_cached_tokens=cached_tokens,
        num_active_tokens=len(active_positions),
    )


def build_plan(store: Optional[ChunkStore], system_tokens: np.ndarray,
               chunks: Sequence[np.ndarray], question_tokens: np.ndarray,
               *, strategy: str = "cachecraft",
               rng: Optional[np.random.Generator] = None,
               force_recompute_fraction: Optional[float] = None
               ) -> InferencePlan:
    """``strategy`` names a registered ``core.strategies`` policy (or is
    an already-resolved instance); it governs both hit classification
    and recompute-token choice. ``force_recompute_fraction`` overrides
    the CFO-derived fraction (used by the fixed-budget baselines
    Random-Recomp / Prefill-H2O and the frontier sweeps)."""
    # lazy: strategies imports Segment/ChunkDecision from this module
    from repro_torch.core.strategies import get_strategy
    strat = get_strategy(strategy)

    segs: List[Segment] = []
    pos = 0
    all_parts = [np.asarray(system_tokens)] + [np.asarray(c) for c in chunks]
    hashes = prompt_hashes(all_parts[0], all_parts[1:])
    for i, part in enumerate(all_parts):
        segs.append(Segment(stat_id=i, start=pos, end=pos + len(part),
                            tokens=part, chash=hashes[i]))
        pos += len(part)
    q = Segment(stat_id=len(all_parts), start=pos,
                end=pos + len(question_tokens),
                tokens=np.asarray(question_tokens), chash=None)
    pos += len(question_tokens)

    decisions = strat.classify(
        store if strat.needs_store else None, segs, hashes,
        frac_override=force_recompute_fraction, rng=rng)
    return layout_plan(segs, decisions, q, pos)

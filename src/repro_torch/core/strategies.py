"""The recompute-strategy layer: ONE registry-dispatched decision site
for every chunk-cache recompute policy in the stack.

Planning code (``planner.build_plan``), the executor
(``prefill.CacheCraftExecutor``), the typed serving spec
(``serving.api.EngineSpec``), and the launcher (``launch/serve.py
--strategy``) never inspect a strategy name again — they carry the NAME
and the name resolves here, exactly like ``models.backend.BACKENDS``
resolves ``attn_impl`` (CI greps for stray ``strategy ==`` ladders
outside this module).

Dispatch contract
-----------------
Every strategy is an instance of :class:`RecomputeStrategy` registered
in :data:`STRATEGIES` under its declared ``name``, with

``classify(store, segments, hashes, *, frac_override, rng)
    -> [ChunkDecision]``
    the hit/miss + layout policy: one decision per cacheable segment,
    in segment order. The default implementation is the Cache-Craft
    flow (``ChunkStore.best_variant`` CFO probe, then
    ``select_tokens`` on the stored Eq. 14 scores); ``prefix``
    overrides it wholesale (exact-prefix reuse, no recomputation) and
    deviation-probed strategies (``blend``) emit hit decisions with
    ``deferred=True`` so the executor finalizes the token choice after
    its first-window probe.

``select_tokens(scores, frac, rng) -> idx``
    the within-chunk choice: sorted indices (chunk-local) of the
    tokens to recompute, given a :class:`SelectScores` bundle and the
    recompute fraction ``frac`` (``ceil(frac * len)`` tokens, with the
    shared early-outs: 0 tokens -> empty, >= len -> everything).
    ``random`` REQUIRES an rng — the plan level owns one (the executor
    seeds a single generator per instance); re-seeding per call would
    silently correlate the Random-Recomp baseline across chunks (the
    legacy ``core.select`` shim keeps a seeded default behind an
    explicit kwarg only).

``needs_store`` (class flag)
    whether the strategy consumes a chunk store at all. ``all`` (the
    Full-Recomp oracle) declares False: ``build_plan`` and
    ``serving.api.build_engine`` gate the store on this flag instead
    of string-matching the name.

``predicts_residency`` (class flag)
    whether the engine's delta-block admission estimate may probe
    ``best_variant`` to predict pool-resident shared runs. ``prefix``
    (exact-prefix reuse only — the CFO probe over-predicts) and
    ``all`` (storeless) declare False.

``needs_deviation`` (class flag)
    whether hit decisions defer token choice to the executor's
    KV-deviation probe (CacheBlend fusion): the executor recomputes
    the first layer window fully, measures per-token deviation of the
    cached KV against the recomputed KV, and calls ``select_tokens``
    with ``SelectScores.deviation`` populated.

Strategies
----------
``cachecraft``  Eq. 14: top-N by external (inter) attention mass —
                the paper's CFO-prefix fixup.
``random``      Random-Recomp baseline: uniform choice of N tokens.
``h2o``         Prefill-H2O baseline: top-N by total attention
                received as a key (heavy-hitter criterion).
``none``        Full-Cache baseline: reuse hits untouched.
``all``         Full-Recomp oracle: storeless, everything computed.
``prefix``      Prefix-Cache baseline (§5.1.4): a chunk reuses its
                cache only when the ENTIRE preceding prefix matches a
                stored context exactly; the first mismatch breaks
                reuse for every later chunk.
``blend``       CacheBlend-style fusion (PAPERS.md): recompute the
                first layer window fully, rank tokens by KV deviation
                of cached vs recomputed values, and fix the
                top-deviation tokens ANYWHERE in the chunk — not just
                the CFO prefix. Bit-identical to ``all`` at fraction
                1.0 and to ``none`` at 0.0 by construction (the
                shared select early-outs), and order-SENSITIVE where
                ``cachecraft`` is not: the deviation is measured in
                the serving context, so a reordered prompt changes
                the selected set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.planner import ChunkDecision, Segment


@dataclass
class SelectScores:
    """Per-token score bundle handed to ``select_tokens``. A strategy
    reads the channel it declared; channels it does not need stay
    None (``h2o`` falls back from ``total`` to ``inter`` when the
    stored variant predates key-side mass capture)."""
    inter: Optional[np.ndarray] = None      # Eq. 14 external attn mass
    total: Optional[np.ndarray] = None      # H2O: mass received as key
    deviation: Optional[np.ndarray] = None  # blend: KV probe deviation

    def __len__(self) -> int:
        for arr in (self.inter, self.deviation, self.total):
            if arr is not None:
                return len(arr)
        return 0


class RecomputeStrategy:
    """Base contract (see the module docstring). Subclasses declare
    ``name`` and override ``_pick`` (the 0 < n < len case of
    ``select_tokens``) and/or ``classify``."""

    name: str = ""
    needs_store: bool = True
    predicts_residency: bool = True
    needs_deviation: bool = False

    # ---- within-chunk token choice ------------------------------------
    def select_tokens(self, scores: SelectScores, frac: float,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
        """Sorted chunk-local indices of the tokens to recompute."""
        t = len(scores)
        n = int(np.ceil(min(1.0, max(0.0, frac)) * t))
        if n == 0:
            return np.zeros(0, np.int64)
        if n >= t:
            return np.arange(t)
        return np.sort(self._pick(scores, n, rng))

    def _pick(self, scores: SelectScores, n: int,
              rng: Optional[np.random.Generator]) -> np.ndarray:
        raise NotImplementedError

    # ---- hit/miss + layout policy -------------------------------------
    def classify(self, store, segments: Sequence[Segment],
                 hashes: Sequence[str], *,
                 frac_override: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[ChunkDecision]:
        """One ``ChunkDecision`` per cacheable segment, in order. The
        default is the Cache-Craft flow: probe ``best_variant`` for
        the minimum-CFO variant, recompute ``frac_override`` (or the
        CFO-derived fraction) of the chunk via ``select_tokens``."""
        decisions: List[ChunkDecision] = []
        for i, seg in enumerate(segments):
            hit = store.best_variant(seg.chash, hashes[:i]) \
                if store is not None else None
            if hit is None:
                decisions.append(ChunkDecision(
                    seg=seg, variant=None, cfo=1.0,
                    recompute_idx=np.arange(seg.length)))
                continue
            var, cfo_val = hit
            frac = frac_override if frac_override is not None else cfo_val
            if self.needs_deviation:
                # token choice deferred to the executor's KV-deviation
                # probe; the recompute set is finalized there
                decisions.append(ChunkDecision(
                    seg=seg, variant=var, cfo=cfo_val,
                    recompute_idx=np.zeros(0, np.int64), deferred=True))
                continue
            idx = self.select_tokens(SelectScores(
                inter=np.asarray(var.scores.token_inter[:seg.length]),
                total=getattr(var.scores, "token_total", None)),
                frac, rng)
            decisions.append(ChunkDecision(seg=seg, variant=var,
                                           cfo=cfo_val,
                                           recompute_idx=idx))
        return decisions


STRATEGIES: Dict[str, RecomputeStrategy] = {}


def register(cls):
    """Class decorator: instantiate and register under the declared
    name (the registry holds stateless singletons)."""
    inst = cls()
    assert inst.name and inst.name not in STRATEGIES, cls
    STRATEGIES[inst.name] = inst
    return cls


def get_strategy(name) -> RecomputeStrategy:
    """THE strategy dispatch site. Accepts a registered name (or an
    already-resolved instance, so plan helpers compose)."""
    if isinstance(name, RecomputeStrategy):
        return name
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown recompute strategy {name!r}; known: "
            f"{sorted(STRATEGIES)}") from None


@register
class CacheCraftStrategy(RecomputeStrategy):
    """Eq. 14: top-N by external (inter) attention mass."""
    name = "cachecraft"

    def _pick(self, scores, n, rng):
        return np.argsort(-scores.inter, kind="stable")[:n]


@register
class RandomStrategy(RecomputeStrategy):
    """Random-Recomp baseline: uniform choice of N tokens. Requires a
    plan-level rng — a per-call seeded fallback would replay the same
    draw for every chunk, silently correlating the baseline."""
    name = "random"

    def _pick(self, scores, n, rng):
        if rng is None:
            raise ValueError(
                "strategy 'random' needs an rng from the plan level "
                "(the executor owns one; legacy callers of "
                "core.select.select_recompute_tokens can opt into the "
                "old seeded default with seeded_default=True)")
        return rng.choice(len(scores), size=n, replace=False)


@register
class H2OStrategy(RecomputeStrategy):
    """Prefill-H2O baseline: top-N by total attention received as a
    key (the heavy-hitter criterion); falls back to inter mass when
    the variant has no key-side statistic."""
    name = "h2o"

    def _pick(self, scores, n, rng):
        src = scores.total if scores.total is not None else scores.inter
        return np.argsort(-np.asarray(src), kind="stable")[:n]


@register
class NoneStrategy(RecomputeStrategy):
    """Full-Cache baseline: hits are reused untouched (no
    recomputation), independent of the requested fraction."""
    name = "none"

    def select_tokens(self, scores, frac, rng=None):
        return np.zeros(0, np.int64)


@register
class AllStrategy(RecomputeStrategy):
    """Full-Recomp oracle: storeless — every chunk is a miss and every
    token recomputed. A nonzero fraction always selects everything
    (legacy ``core.select`` semantics, kept bit-identical)."""
    name = "all"
    needs_store = False
    predicts_residency = False

    def select_tokens(self, scores, frac, rng=None):
        t = len(scores)
        n = int(np.ceil(min(1.0, max(0.0, frac)) * t))
        if n == 0:
            return np.zeros(0, np.int64)
        return np.arange(t)


@register
class PrefixStrategy(RecomputeStrategy):
    """Prefix-Cache baseline (§5.1.4): a chunk reuses its cache only
    if the ENTIRE preceding prefix matches a stored context exactly
    (and all earlier chunks hit too); no recomputation. The engine's
    delta-block estimate must not probe ``best_variant`` for this
    strategy — the CFO probe over-predicts sharing."""
    name = "prefix"
    predicts_residency = False

    def classify(self, store, segments, hashes, *, frac_override=None,
                 rng=None):
        decisions: List[ChunkDecision] = []
        prefix_broken = False
        for i, seg in enumerate(segments):
            exact = None
            if not prefix_broken and store is not None:
                for var in store.lookup(seg.chash):
                    if list(var.scores.prefix_hashes) == list(hashes[:i]) \
                            and var.scores.orig_start == seg.start:
                        exact = var
                        break
            if exact is None:
                prefix_broken = True
                decisions.append(ChunkDecision(
                    seg=seg, variant=None, cfo=1.0,
                    recompute_idx=np.arange(seg.length)))
            else:
                decisions.append(ChunkDecision(
                    seg=seg, variant=exact, cfo=0.0,
                    recompute_idx=np.zeros(0, np.int64)))
        return decisions

    def select_tokens(self, scores, frac, rng=None):
        return np.zeros(0, np.int64)


@register
class BlendStrategy(RecomputeStrategy):
    """CacheBlend-style fusion: top-N by per-token KV deviation of the
    cached values against a full recomputation of the first layer
    window, selected ANYWHERE in the chunk. The deviation channel is
    measured by the executor (``needs_deviation``); classification
    defers the token choice until that probe has run."""
    name = "blend"
    needs_deviation = True

    def _pick(self, scores, n, rng):
        if scores.deviation is None:
            raise ValueError(
                "strategy 'blend' selects on the executor's KV "
                "deviation probe; SelectScores.deviation missing")
        return np.argsort(-scores.deviation, kind="stable")[:n]

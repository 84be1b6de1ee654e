"""Unified eviction policy for every chunk-cache eviction site (§3.5).

Before this module, the repro had three fragmented eviction code paths:
``TieredStore`` demoted by plain LRU, ``ChunkStore`` capped variants by
its own lowest-``f_r`` rule, and ``PoolResidency`` reclaimed cold pool
runs in materialization (dict) order. One ``EvictionPolicy`` is now the
single victim-selection source for all three sites; each site builds
``Candidate`` rows from its own bookkeeping and asks the policy to pick
(or order) victims.

Two policies ship:

* ``LRUPolicy`` — recency only (``last_access``). At the tier site this
  reproduces the pre-refactor demotion order bit-for-bit.
* ``ReuseAwarePolicy`` — full GDSF priority with an aging clock:

      ``h(entry) = L_at_last_touch + reuse_freq x recompute_cost / nbytes``

  (lowest ``h`` evicted first; on each eviction the global clock ``L``
  rises to the victim's priority). ``reuse_freq`` is the variant's
  ``f_r`` (accumulated ``1/CFO`` — reuse likelihood already weighted by
  how expensive a miss is to fix, §3.3) and ``recompute_cost`` is the
  chunk's token count (recompute FLOPs are linear in tokens). Because
  chunk-cache bytes are also linear in tokens, ``cost/size`` is a
  constant ratio within one store and, at ``L = 0``, the score reduces
  exactly to the pre-refactor lowest-``f_r`` capping rule at the
  ``ChunkStore`` site — while at the tier site it keeps
  frequently-reused variants resident where LRU would let a cold scan
  flush them ("From Prefix Cache to Fusion RAG Cache": chunk caches
  want reuse-frequency-aware placement, not recency-only).

  The ``L`` term is what lets *stale*-hot entries decay: an entry's
  priority is frozen at the clock value of its last touch
  (``last_access`` change), so an entry that was popular long ago but
  is never touched again keeps a low inflation term while every fresh
  entry is scored against the risen clock. Once the workload's
  popularity shifts, the stale entry's frozen ``h`` falls below the
  newcomers' and it is evicted — without the clock, a one-time-hot
  entry with a large benefit score could squat in HBM forever.

Ties break on first-candidate-wins (all sites iterate their containers
in deterministic insertion order), so policy decisions are reproducible
run to run — the ``fig22_eviction_{lru,reuse}`` bench gates on exact
tier-miss counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence


@dataclass
class Candidate:
    """One evictable entry, as seen by a policy.

    ``key`` is opaque to the policy (a tier key string, a ``Variant``,
    a ``SharedRun`` — whatever the site evicts). ``nbytes`` is the
    entry's STORED size — at the tier site that is the quantized
    representation's bytes (``core.tiers`` "Quantized tiers"), so GDSF
    prices an entry by the capacity it actually occupies, not its fp32
    footprint. ``last_access`` is a monotonic timestamp or sequence
    number; larger means more recent. ``reuse_freq``/``recompute_cost``
    come from the chunk store's per-variant hit/CFO stats (zero/one for
    entries without stats)."""
    key: Any
    nbytes: int
    last_access: float = 0.0
    reuse_freq: float = 0.0
    recompute_cost: float = 1.0


# type of the per-key stats feed a site may wire in (e.g. the chunk
# store feeding variant stats to the tier store):
#   stats_fn(key) -> (reuse_freq, recompute_cost)
StatsFn = Callable[[Any], tuple]


class EvictionPolicy:
    """Victim selection: lowest ``score`` evicted first."""

    name = "base"

    def score(self, c: Candidate) -> float:
        raise NotImplementedError

    def select(self, candidates: Iterable[Candidate]
               ) -> Optional[Candidate]:
        """The single next victim (``None`` if no candidates). Python's
        ``min`` keeps the *first* minimal element, which is what makes
        the LRU policy reproduce the pre-refactor tie-breaks."""
        candidates = list(candidates)
        if not candidates:
            return None
        return min(candidates, key=self.score)

    def order(self, candidates: Sequence[Candidate]) -> List[Candidate]:
        """All candidates, worst (evict-first) to best; stable."""
        return sorted(candidates, key=self.score)


class LRUPolicy(EvictionPolicy):
    """Recency-only baseline: evict the least-recently-used entry."""

    name = "lru"

    def score(self, c: Candidate) -> float:
        return c.last_access


class ReuseAwarePolicy(EvictionPolicy):
    """GDSF reuse-aware scoring with an aging clock (module docstring).

    Stateful: the instance carries the clock ``L`` and a per-key cache
    of ``(last_access, priority)``. A priority is recomputed only when
    the entry is touched (its ``last_access`` changed) — that freeze is
    the whole mechanism; re-adding ``L`` to every candidate on every
    call would shift all scores equally and never decay anything."""

    name = "reuse"

    def __init__(self):
        self.clock = 0.0       # aging clock L; rises to each victim's h
        self._prio: dict = {}  # cache key -> (last_access, priority h)

    @staticmethod
    def _ckey(c: Candidate):
        # site keys may be unhashable dataclasses (Variant, SharedRun);
        # identity is a fine stand-in — a recycled id() is caught by the
        # last_access check and the cache is pruned in select()
        try:
            hash(c.key)
        except TypeError:
            return id(c.key)
        return c.key

    def _benefit(self, c: Candidate) -> float:
        return c.reuse_freq * c.recompute_cost / max(1, c.nbytes)

    def score(self, c: Candidate) -> float:
        k = self._ckey(c)
        rec = self._prio.get(k)
        if rec is None or rec[0] != c.last_access:
            rec = (c.last_access, self.clock + self._benefit(c))
            self._prio[k] = rec
        return rec[1]

    def select(self, candidates: Iterable[Candidate]
               ) -> Optional[Candidate]:
        candidates = list(candidates)
        victim = super().select(candidates)
        if victim is not None:
            h = self.score(victim)
            if h > self.clock:
                self.clock = h          # GDSF clock advance
            self._prio.pop(self._ckey(victim), None)
            if len(self._prio) > max(256, 4 * len(candidates)):
                # bound the cache: keep only currently-live candidates
                # (rarely triggers; sites offer their full container)
                live = {self._ckey(c) for c in candidates}
                self._prio = {k: v for k, v in self._prio.items()
                              if k in live}
        return victim


_POLICIES = {"lru": LRUPolicy, "reuse": ReuseAwarePolicy}


def get_policy(name_or_policy) -> EvictionPolicy:
    """'lru' | 'reuse' | an EvictionPolicy instance -> instance."""
    if isinstance(name_or_policy, EvictionPolicy):
        return name_or_policy
    return _POLICIES[name_or_policy]()

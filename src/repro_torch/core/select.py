"""DEPRECATED shim over ``core.strategies`` (kept for one release).

Token selection for recomputation (paper §3.2.1, Eq. 14) and the
baseline strategies now live in the registry-dispatched strategy layer
— see ``core.strategies`` for the contract and the full strategy list.
``select_recompute_tokens`` delegates to
``STRATEGIES[strategy].select_tokens`` and exists only so legacy
callers keep working; new code should resolve a strategy via
``core.strategies.get_strategy`` instead.
"""
from __future__ import annotations

import numpy as np


def select_recompute_tokens(token_inter: np.ndarray, cfo: float,
                            strategy: str = "cachecraft",
                            rng: np.random.Generator | None = None,
                            token_total: np.ndarray | None = None,
                            seeded_default: bool = False
                            ) -> np.ndarray:
    """Return sorted indices (within the chunk) of the tokens to
    recompute, via the ``core.strategies`` registry.

    ``random`` requires an ``rng`` — the historic silent
    ``default_rng(0)`` fallback re-seeded identically on every call,
    correlating the Random-Recomp baseline across chunks. Pass
    ``seeded_default=True`` to explicitly opt back into that fixed
    seed (deterministic one-off scripts only).
    """
    from repro_torch.core.strategies import SelectScores, get_strategy

    if rng is None and seeded_default:
        rng = np.random.default_rng(0)
    return get_strategy(strategy).select_tokens(
        SelectScores(inter=np.asarray(token_inter), total=token_total),
        cfo, rng)

"""Frozen copy of Cache-Craft's selection rule, and the check of a
captured plan against it.

Copied from the port's ``core/chunkstore.py`` (``chunk_hash``,
``prompt_hashes``, ``ChunkStore.best_variant``), ``core/scoring.py``
(``beta_score``, ``kendall_tau_distance``, ``beta_prime``, ``cfo``:
Eqs. 6-8 and 12 with alpha 1 and beta' on) and ``core/strategies.py``
(``RecomputeStrategy.select_tokens`` and ``CacheCraftStrategy._pick``:
the ``ceil(CFO * length)`` tokens of most external attention). It
imports nothing of the program.

``plan_mismatches`` takes a request's prompt (system, chunks, question),
the variants its plan chose among (with the scores they were stored
with) and the plan's decisions, and the position rows each layer window
computed. It hashes the prompt itself, picks each segment's variant and
recompute tokens by the rule, and counts what differs: a chosen variant,
a CFO, a recompute set, the rows of the first window (every recomputed
token, every token of a missed segment, the question), and any later
window that computes a row the one before it did not, or drops a row of
a missed segment, of the question, or part of a reused chunk's
recomputed tokens (focus drops whole chunks)."""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

ALPHA = 1.0
CFO_TOL = 1e-9


def chunk_hash(tokens) -> str:
    return hashlib.sha256(np.asarray(tokens, np.int32).tobytes()
                          ).hexdigest()[:16]


def prompt_hashes(system, chunks) -> List[str]:
    return ["SYS-" + chunk_hash(system)] + [chunk_hash(c) for c in chunks]


def beta_score(scores, new_prefix: Sequence[str]) -> float:
    total = sum(scores.prefix_inter)
    if total <= 0:
        return 1.0
    new = set(new_prefix)
    kept = sum(w for h, w in zip(scores.prefix_hashes, scores.prefix_inter)
               if h in new)
    return float(kept / total)


def kendall_tau(old: Sequence[str], new: Sequence[str]) -> float:
    new_set = set(new)
    common = [h for h in old if h in new_set]
    m = len(common)
    if m < 2:
        return 0.0
    rank = {h: r for r, h in enumerate(new)}
    d = sum(1 for x in range(m) for y in range(x + 1, m)
            if rank[common[x]] > rank[common[y]])
    return float(d) / (m * (m - 1) / 2)


def cfo(scores, new_prefix: Sequence[str]) -> float:
    bp = beta_score(scores, new_prefix) * (
        1.0 - kendall_tau(scores.prefix_hashes, new_prefix))
    return float(min(1.0, ALPHA * scores.cci * (1.0 - bp)))


def recompute_tokens(inter: np.ndarray, frac: float) -> np.ndarray:
    t = len(inter)
    n = int(np.ceil(min(1.0, max(0.0, frac)) * t))
    if n == 0:
        return np.zeros(0, np.int64)
    if n >= t:
        return np.arange(t)
    return np.sort(np.argsort(-np.asarray(inter), kind="stable")[:n])


def plan_mismatches(system, chunks, question, plan: Dict,
                    windows: List[tuple]) -> int:
    """``plan``: {"decisions": per cacheable segment {"start", "end",
    "chash", "variant", "cfo", "recompute", "candidates": [(variant id,
    scores)] held under that hash when the plan was made},
    "question": (start, end)}; ``windows``: [(l0, l1, tail, rows)] in
    layer order."""
    parts = [np.asarray(system)] + [np.asarray(c) for c in chunks]
    hashes = prompt_hashes(parts[0], parts[1:])
    decs = plan["decisions"]
    bad = 0
    if len(decs) != len(parts):
        return 1
    want_rows = []
    reused = []                      # recomputed rows of each reused chunk
    fixed = set()                    # rows focus never drops
    start = 0
    for i, (part, d) in enumerate(zip(parts, decs)):
        end = start + len(part)
        bad += (d["start"], d["end"]) != (start, end)
        # the variants the store held under the hash the program looked up
        bad += d["chash"] != hashes[i]
        best, best_cfo = None, None
        for vid, sc in d["candidates"]:
            c = cfo(sc, hashes[:i])
            if best_cfo is None or c < best_cfo:
                best, best_cfo = (vid, sc), c
        if best is None:
            bad += d["variant"] is not None
            rows = start + np.arange(len(part))
            fixed.update(rows.tolist())
        else:
            vid, sc = best
            bad += d["variant"] != vid
            bad += abs(float(d["cfo"]) - best_cfo) > CFO_TOL
            idx = recompute_tokens(
                np.asarray(sc.token_inter[:len(part)], np.float64), best_cfo)
            bad += not np.array_equal(np.asarray(d["recompute"]), idx)
            rows = start + idx
            if i == 0:
                fixed.update(rows.tolist())
            elif len(rows):
                reused.append(set(rows.tolist()))
        want_rows.append(rows)
        start = end
    q0, q1 = plan["question"]
    bad += (q0, q1) != (start, start + len(question))
    q = np.arange(q0, q1)
    fixed.update(q.tolist())
    want = set(np.concatenate(want_rows + [q]).tolist())
    prev = None
    for _l0, _l1, _tail, rows in windows:
        got = set(np.asarray(rows).tolist())
        if prev is None:
            bad += got != want
        else:
            bad += not got <= prev
            dropped = prev - got
            bad += bool(dropped & fixed)
            bad += sum(1 for s in reused if dropped & s and not s <= dropped)
        prev = got
    return int(bad)


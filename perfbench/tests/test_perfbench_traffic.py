"""The traffic generator: the same seed gives the same requests, every
seed gets the same sizes and arrivals in the same order, and the sizes are
as the traffic files state."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spec  # noqa: E402
from perfbench.traffic import Trace, exp_gaps, stratified  # noqa: E402

SEED = 2 ** 31 + 12345
# every traffic file, and the generator's every-chunk-new mode (the cold
# cell that PERF.md keeps for later) on rag_reuse's lengths
MIXES = {path.stem: spec.traffic(path.stem)
         for path in sorted((spec.HERE / "traffic").glob("*.json"))}
MIXES["fresh"] = dict(MIXES["rag_reuse"], fresh_chunks=True, kb_chunks=0)


def _sig(tr):
    return [(r.idx, r.session, r.system.tobytes(), r.question.tobytes(),
             tuple(c.tobytes() for c in r.chunks), r.max_new, r.due)
            for r in tr.requests]


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed(name):
    p = MIXES[name]
    a = Trace(p, SEED, 102400, 20.0)
    b = Trace(p, SEED, 102400, 20.0)
    c = Trace(p, SEED + 1, 102400, 20.0)
    assert _sig(a) == _sig(b)
    assert _sig(a) != _sig(c)


@pytest.mark.parametrize("name", MIXES)
def test_sized_as_stated(name):
    p = MIXES[name]
    tr = Trace(p, SEED, 49155, 30.0)
    lo, hi = p["chunk_len"]
    olo, ohi = p["output_len"]
    assert len(tr.warmup) == p["warmup_requests"]
    for r in tr.requests:
        assert len(r.system) == p["sys_len"]
        assert len(r.question) == p["question_len"]
        assert len(r.chunks) == p["k"] == len(set(r.chunk_ids))
        assert all(lo <= len(c) <= hi for c in r.chunks)
        assert olo <= r.max_new <= ohi
        assert all(int(c.max()) < 49155 for c in r.chunks)
    if p["kind"] == "open_loop":
        assert len(tr.window) == int(np.floor(p["rate_per_s"] * 30.0))
        dues = [r.due for r in tr.window]
        assert dues == sorted(dues) and 0 < dues[-1] < 30.0
    else:
        assert len(tr.window) == p["clients"] * p["requests_per_client"]
    if p.get("fresh_chunks"):
        ids = [c for r in tr.requests for c in r.chunk_ids]
        assert len(ids) == len(set(ids))
    else:
        assert len(tr.kb) == p["kb_chunks"]


@pytest.mark.parametrize("name", MIXES)
def test_same_sizes_for_every_seed(name):
    """Every seed gets the same sizes and arrivals in the same order;
    only the tokens differ."""
    p = MIXES[name]
    a = Trace(p, SEED, 102400, 20.0)
    b = Trace(p, 7, 102400, 20.0)
    for ra, rb in zip(a.requests, b.requests, strict=True):
        assert ra.session == rb.session and ra.chunk_ids == rb.chunk_ids
        assert [len(c) for c in ra.chunks] == [len(c) for c in rb.chunks]
        assert ra.max_new == rb.max_new and ra.due == rb.due
    assert [len(c) for c in a.kb] == [len(c) for c in b.kb]
    assert any(not np.array_equal(x, y) for x, y in zip(a.kb, b.kb))


def test_reuse_repeats_chunks_and_rotates_turns():
    p = spec.traffic("rag_reuse")
    tr = Trace(p, SEED, 102400, 40.0)
    ids = [c for r in tr.requests for c in r.chunk_ids]
    assert len(set(ids)) < len(ids) / 2
    first = {}
    rotated = 0
    for r in tr.requests:
        prev = first.setdefault(r.session, r.chunk_ids)
        rotated += set(prev) == set(r.chunk_ids) and prev != r.chunk_ids
    assert rotated > 0


def test_multisets():
    assert list(stratified(10, 20, 3)) == [12, 15, 18]
    g = exp_gaps(2.0, 1000)
    assert abs(g.mean() - 0.5) < 0.01

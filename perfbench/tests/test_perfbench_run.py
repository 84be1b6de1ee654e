"""A whole run of each cell at tiny widths on the CPU: the result line's
schema, and the comparison that decides ``correct`` coming out false when
the timed path is broken underneath (a served token altered where it is
produced, a decode step that hands back its state unchanged, a stored
chunk altered when it is written, in the window or in the warm-up, a
tier handing back other bytes than it was given, a plan that recomputes
other tokens than the selection rule picks), and the float8 control
judged by the same comparison coming out not correct."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import _tiny  # noqa: E402
from perfbench import harness, spec  # noqa: E402

SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(cell, trace=False, fault=None, seconds=3.0, traffic=None):
    ov = _tiny.overrides(cell)
    ov["traffic"] = {**ov["traffic"], **(traffic or {})}
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=ov, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, capsys):
    line = _run(cell)
    harness.print_result(line)
    out = capsys.readouterr()
    parsed = json.loads(out.out.strip().splitlines()[-1])
    assert list(parsed)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in parsed
    assert parsed["correct"] is True, parsed["checks"]
    assert parsed["failed"] == 0 and parsed["attempted"] > 0
    bench = spec.benchmark()
    want = {m["name"] for m in spec.metrics_for(bench, "end_to_end", cell)}
    assert set(parsed["metrics"]) == want
    for m in parsed["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(parsed["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    tail = out.err.strip().splitlines()[-len(parsed["checks"]):]
    assert [t.split(":")[0] for t in tail] == \
        [f"check {name}" for name in parsed["checks"]]


def test_traced_line_has_layer_metrics():
    line = _run("ds67b-rag-reuse", trace=True)
    assert line["correct"]
    # the device's metrics need the card; the program's and the host's
    # are read here
    for name in ("prefill_pass_ms", "queue_wait_p90_ms", "tail_ttft_p90_ms",
                 "computed_token_share", "chunk_hit_share", "prefill_mfu"):
        assert name in line["metrics"], name


def _alter_token(eng):
    """Decode steps put the next token of every row's request one id
    above its best, at its third output token."""
    orig = eng._decode_fn

    def fn(params, tokens, positions, cache, slots=None):
        logits, cache = orig(params, tokens, positions, cache, slots)
        for i, r in enumerate(eng._rows):
            if r is not None and len(r.output_tokens) == 2:
                best = int(logits[i, 0].argmax())
                logits[i, 0, (best + 1) % eng.cfg.vocab_size] += 1e4
        return logits, cache
    eng._decode_fn = fn


def _stale_state(eng):
    """Decode steps hand back the cache they were given: the new token's
    KV is never written."""
    orig = eng._decode_fn

    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, list):
            return [clone(v) for v in x]
        return x.clone()

    def fn(params, tokens, positions, cache, slots=None):
        logits, _new = orig(params, tokens, positions, clone(cache), slots)
        return logits, cache
    eng._decode_fn = fn


def _alter_stored(eng):
    """The chunk store is handed K scaled by 1.5."""
    orig = eng.store.add_variant

    def add(chash, kv, scores):
        kv = dict(kv, k=np.asarray(kv["k"]) * 1.5)
        return orig(chash, kv, scores)
    eng.store.add_variant = add


def _alter_tier_read(eng):
    """The tiers hand back each layer slice with its K shifted."""
    tiers = eng.store.tiers
    orig = tiers.get

    def get(key, *a, **kw):
        kv, info = orig(key, *a, **kw)
        if kv is not None and "k" in kv:
            kv = dict(kv, k=np.asarray(kv["k"]) + 0.5)
        return kv, info
    tiers.get = get


def _skew_plan(eng):
    """The planner is handed half the CFO of each variant it picks: it
    recomputes fewer tokens than the selection rule asks for."""
    orig = eng.store.best_variant

    def best(chash, prefix):
        hit = orig(chash, prefix)
        return None if hit is None else (hit[0], hit[1] * 0.5)
    eng.store.best_variant = best


def _alter_warmup_stored(eng):
    """The chunks the warm-up's requests store are handed to the store
    with K scaled by 1.5; the window's are not."""
    n_warm = _tiny.OPEN["warmup_requests"]
    orig_pass, orig_add = eng._run_prefills, eng.store.add_variant
    state = {"warm": False}

    def run_prefills(reqs):
        state["warm"] = any(r.rid < n_warm for r in reqs)
        return orig_pass(reqs)

    def add(chash, kv, scores):
        if state["warm"]:
            kv = dict(kv, k=np.asarray(kv["k"]) * 1.5)
        return orig_add(chash, kv, scores)
    eng._run_prefills = run_prefills
    eng.store.add_variant = add


@pytest.mark.parametrize("fault,cell,check", [
    (_alter_token, "ds67b-rag-reuse", "served_gap"),
    (_alter_token, "granite-decode", "served_gap"),
    (_stale_state, "ds67b-rag-reuse", "served_gap"),
    (_stale_state, "granite-decode", "served_gap"),
    (_alter_stored, "ds67b-rag-reuse", "store_kv_err"),
    (_alter_tier_read, "ds67b-rag-reuse", "store_read_mismatch"),
    (_skew_plan, "ds67b-rag-reuse", "plan_mismatch"),
    (_alter_warmup_stored, "ds67b-rag-reuse", "store_kv_err"),
], ids=["token-ds67b", "token-granite", "state-ds67b", "state-granite",
        "stored-kv", "tier-read", "plan", "warmup-stored-kv"])
def test_broken_path_is_not_correct(fault, cell, check):
    # a stale decode state shows once the answer outgrows its first
    # tokens, as the cells' answers do (32 and 128-512 tokens)
    longer = {"output_len": [24, 32]} if fault is _stale_state else None
    line = _run(cell, fault=fault, traffic=longer)
    assert line["correct"] is False
    c = line["checks"][check]
    assert c["value"] > c["limit"], line["checks"]


def test_control_in_the_programs_place_is_not_correct():
    """The float8 control goes through the same comparison as the
    program (``harness.judge``) and comes out not correct; the program's
    own run of the same window is correct."""
    cell = "granite-decode"
    sv = harness.serve(cell, SEED, 3.0, False, device="cpu",
                       overrides=_tiny.overrides(cell))
    assert harness.judge(sv, SEED, "cpu")["correct"] is True
    line = harness.judge(sv, SEED, "cpu", control=True)
    assert line["correct"] is False, line["checks"]

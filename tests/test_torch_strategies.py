"""The recompute-strategy layer inside the port (the reference's
``tests/test_strategies.py``, re-proved on the port) and held against the
JAX package: every registered strategy through the executor and through
the ``Engine``, on ``dense`` and on ``kernel``.

Tiny llama3-8b with the reference's weights (``params_from_jax``), on
the CPU, the reference's inputs. The reference gates run on the port:
``build_plan`` over an executor-warmed store equal to the pre-registry
selection ladder, ``blend`` == ``all`` at fraction 1 and == ``none`` at
0 byte for byte, ``blend`` order-sensitive where ``cachecraft`` is not,
and ``EngineSpec.from_args`` gating the store on ``needs_store``.

Against the JAX package (its ``kernel`` route runs its Pallas kernels in
interpret mode): each package warms its own store with its own executor,
then every strategy runs on it; plans must be equal, logits and KV within
2e-4; the port's runs take the JAX runs' choices and log their own, so
that a near tie is counted and its run still compared in value. ``h2o``
on ``kernel`` plans from inter mass alone in both packages (the chunk
kernel returns no key mass; ROADMAP C5). ``blend`` ranks by a probe of
the first layer window's KV: on llama3-8b that is layer 0, which no
other token influences, so its deviations are rounding noise (at most
ROUNDING_DEV) and rank nothing (ROADMAP C11); on tiny gemma3-4b the
window spans four layers, and there the deviations of a moved chunk are
held to the reference's and its choices must be equal. Through the
engines: completed requests, per-request hits and computed tokens equal,
tokens and decode logits within 2e-4 while the tokens agree (a greedy
flip only at a near tie). ``-k rehearsal`` runs chip_smoke.py's
strategies phase on tiny llama3-8b on the CPU."""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.planner import build_plan as j_build_plan
from repro.core.strategies import get_strategy as j_get_strategy
from repro.core.tiers import TieredStore as JTiers
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore, prompt_hashes
from repro_torch.core.planner import (ChunkDecision, Segment, build_plan,
                                      layout_plan)
from repro_torch.core.strategies import (STRATEGIES, SelectScores,
                                         get_strategy)
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate
from test_torch_executor import (IMPLS, NEAR_TIE, RO, ROUNDING_DEV, TOL,
                                 assert_same_run, jax_pkg, near_ties,
                                 new_store, port_pkg, recording, run,
                                 selection_ties)

torch.set_num_threads(2)
LEGACY_NAMES = ("cachecraft", "random", "h2o", "none", "all", "prefix")


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    kb = [rng.integers(0, V, 24) for _ in range(4)]
    sys_t = rng.integers(0, V, 8)
    q1 = rng.integers(0, V, 12)
    q2 = rng.integers(0, V, 12)
    return dict(port=port_pkg(cfg, tparams), jax=jax_pkg(jcfg, jparams),
                cfg=cfg, tparams=tparams, jcfg=jcfg, jparams=jparams,
                kb=kb, sys_t=sys_t, q1=q1, q2=q2)


# ---- tests/test_strategies.py:193, on the port -----------------------------

def _legacy_select(token_inter, cfo, strategy="cachecraft", rng=None,
                   token_total=None):
    """The pre-registry selection ladder (the reference test's copy)."""
    t = len(token_inter)
    n = int(np.ceil(min(1.0, max(0.0, cfo)) * t))
    if strategy == "none" or n == 0:
        return np.zeros(0, np.int64)
    if strategy == "all" or n >= t:
        return np.arange(t)
    if strategy == "cachecraft":
        idx = np.argsort(-token_inter, kind="stable")[:n]
    elif strategy == "random":
        rng = rng or np.random.default_rng(0)
        idx = rng.choice(t, size=n, replace=False)
    elif strategy == "h2o":
        src = token_total if token_total is not None else token_inter
        idx = np.argsort(-src, kind="stable")[:n]
    else:
        raise ValueError(strategy)
    return np.sort(idx)


def _legacy_build_plan(store, system_tokens, chunks, question_tokens, *,
                       strategy="cachecraft", rng=None,
                       force_recompute_fraction=None):
    """The pre-registry ``build_plan`` decision loop (the reference
    test's copy) on the port's layout helper."""
    segs, pos = [], 0
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

    decisions, prefix_broken = [], False
    for i, seg in enumerate(segs):
        hit = store.best_variant(seg.chash, hashes[:i]) if store else None
        if strategy == "prefix":
            exact = None
            if not prefix_broken and store is not None:
                for var in store.lookup(seg.chash):
                    if list(var.scores.prefix_hashes) == hashes[:i] and \
                            var.scores.orig_start == seg.start:
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
            continue
        if hit is None:
            decisions.append(ChunkDecision(
                seg=seg, variant=None, cfo=1.0,
                recompute_idx=np.arange(seg.length)))
            continue
        var, cfo_val = hit
        frac = (force_recompute_fraction
                if force_recompute_fraction is not None else cfo_val)
        idx = _legacy_select(
            var.scores.token_inter[:seg.length], frac, strategy=strategy,
            rng=rng, token_total=getattr(var.scores, "token_total", None))
        decisions.append(ChunkDecision(seg=seg, variant=var, cfo=cfo_val,
                                       recompute_idx=idx))
    return layout_plan(segs, decisions, q, pos)


def _warm_store(world, tmp_path, tag, pkg="port", impl="dense"):
    w = world
    store = new_store(w[pkg], tmp_path, tag)
    w[pkg].executor(store, use_focus=False, attn_impl=impl).process(
        w["sys_t"], w["kb"][:3], w["q1"])
    return store


@pytest.mark.parametrize("strategy", LEGACY_NAMES)
def test_build_plan_bit_identical_to_legacy(world, tmp_path_factory,
                                            strategy):
    kb, sys_t, q2 = world["kb"], world["sys_t"], world["q2"]
    store = _warm_store(world, tmp_path_factory, f"plan-{strategy}")
    chunks = [kb[1], kb[0], kb[3]]          # reorder + one novel chunk
    for frac in (None, 0.4):
        old = _legacy_build_plan(
            None if strategy == "all" else store, sys_t, chunks, q2,
            strategy=strategy, rng=np.random.default_rng(3),
            force_recompute_fraction=frac)
        new = build_plan(store, sys_t, chunks, q2, strategy=strategy,
                         rng=np.random.default_rng(3),
                         force_recompute_fraction=frac)
        assert len(old.decisions) == len(new.decisions)
        for do, dn in zip(old.decisions, new.decisions):
            assert do.is_hit == dn.is_hit
            assert do.cfo == pytest.approx(dn.cfo)
            np.testing.assert_array_equal(do.recompute_idx,
                                          dn.recompute_idx)
        np.testing.assert_array_equal(old.active_positions,
                                      new.active_positions)
        np.testing.assert_array_equal(old.active_tokens, new.active_tokens)
        np.testing.assert_array_equal(old.active_stat_ids,
                                      new.active_stat_ids)
        assert old.num_cached_tokens == new.num_cached_tokens
        assert old.num_active_tokens == new.num_active_tokens


# ---- every strategy through the executor, both packages --------------------

def strategy_runs(pkg, w, tmp, impl, ref=None):
    """Each package's own executor-warmed store, then only reads: every
    strategy at 0.3 on a reordered prompt with a novel chunk,
    ``cachecraft`` at its own CFO, the blend endpoints beside ``all`` and
    ``none``, and ``blend`` / ``cachecraft`` on a prompt and its
    rotation; with ``ref`` (the other package's runs) each run takes that
    run's choices. Returns the runs and the store."""
    kb, sys_t, q2 = w["kb"], w["sys_t"], w["q2"]
    store = _warm_store(w, tmp, f"{pkg.name}-{impl}-strategies", pkg.name,
                        impl)

    def ex(strategy, frac, s=store):
        return recording(pkg.executor(
            s, strategy=strategy, use_focus=False, attn_impl=impl,
            force_recompute_fraction=frac, **RO))

    out = {}

    def put(key, e, chunks):
        out[key] = run(e, sys_t, chunks, q2,
                       None if ref is None else ref[key]["selections"])

    novel, endpoints = [kb[1], kb[0], kb[3]], [kb[1], kb[0], kb[2]]
    orig, rot = [kb[0], kb[1], kb[2]], [kb[2], kb[0], kb[1]]
    for name in STRATEGIES:
        put(f"{name} 0.3", ex(name, 0.3), novel)
    put("cachecraft cfo", ex("cachecraft", None), novel)
    put("all", ex("all", None, None), endpoints)
    put("none", ex("none", None), endpoints)
    put("blend 1.0", ex("blend", 1.0), endpoints)
    put("blend 0.0", ex("blend", 0.0), endpoints)
    for strat in ("blend", "cachecraft"):
        e = ex(strat, 0.3)
        put(f"{strat} orig", e, orig)
        put(f"{strat} rot", e, rot)
    return out, store


RUN_KEYS = tuple(f"{n} 0.3" for n in STRATEGIES) + (
    "cachecraft cfo", "all", "none", "blend 1.0", "blend 0.0", "blend orig",
    "blend rot", "cachecraft orig", "cachecraft rot")


@pytest.fixture(scope="module")
def sruns(world, tmp_path_factory):
    """{(package, impl): strategy_runs}: the JAX executor's, then the
    port's on their choices."""
    out = {}
    for impl in IMPLS:
        out["jax", impl] = strategy_runs(world["jax"], world,
                                         tmp_path_factory, impl)
        out["port", impl] = strategy_runs(world["port"], world,
                                          tmp_path_factory, impl,
                                          out["jax", impl][0])
    return out


def own_idx(r):
    """The tokens a run chose itself for each decision (its log: the
    plan holds the other package's choice where they differ at a near
    tie)."""
    assert len(r["selections"]) == sum(r["hits"])
    log = iter(r["selections"])
    return [next(log)[2].tolist() if h else i
            for h, i in zip(r["hits"], r["idx"])]


# ---- tests/test_strategies.py:229, :244, :266, on the port -----------------

@pytest.mark.parametrize("impl", IMPLS)
def test_blend_equals_all_at_fraction_one(sruns, impl):
    runs = sruns[("port", impl)][0]
    rb, ra = runs["blend 1.0"], runs["all"]
    assert all(len(i) == n for i, n in zip(rb["idx"], rb["lengths"]))
    for key in ("logits", "k", "v"):
        np.testing.assert_array_equal(rb[key], ra[key])


@pytest.mark.parametrize("impl", IMPLS)
def test_blend_equals_none_at_fraction_zero(sruns, impl):
    runs = sruns[("port", impl)][0]
    rb, rn = runs["blend 0.0"], runs["none"]
    assert all(len(i) == 0 for i, h in zip(rb["idx"], rb["hits"]) if h)
    for key in ("logits", "k", "v"):
        np.testing.assert_array_equal(rb[key], rn[key])


@pytest.mark.parametrize("impl", IMPLS)
def test_blend_selection_is_order_sensitive_cachecraft_is_not(sruns, impl):
    """Rotating the context moves kb[0]'s tokens and neighbours, so
    ``blend`` (deviation measured in the serving context) picks another
    set, while ``cachecraft`` reads the same stored scores either way.
    kb[0] is decision 1 of the original order and 2 of the rotation."""
    runs = sruns[("port", impl)][0]
    for strat in ("blend", "cachecraft"):
        assert all(runs[f"{strat} orig"]["hits"])
        assert all(runs[f"{strat} rot"]["hits"])
    assert own_idx(runs["cachecraft orig"])[1] == \
        own_idx(runs["cachecraft rot"])[2]
    assert own_idx(runs["blend orig"])[1] != own_idx(runs["blend rot"])[2]


def test_from_args_store_gating_via_needs_store():
    ns = argparse.Namespace(strategy="all", device="cpu")
    assert EngineSpec.from_args(ns).store is None
    for name in ("cachecraft", "blend", "prefix"):
        assert EngineSpec.from_args(
            argparse.Namespace(strategy=name, device="cpu")).store \
            is not None


def test_unknown_strategy_raises_with_name():
    with pytest.raises(ValueError, match="bogus"):
        get_strategy("bogus")
    with pytest.raises(ValueError, match="bogus"):
        EngineSpec(strategy="bogus").validate()
    for name in STRATEGIES:
        assert EngineSpec(strategy=name).validate().strategy == name


# ---- against the JAX executor ----------------------------------------------

@pytest.mark.parametrize("key", RUN_KEYS)
@pytest.mark.parametrize("impl", IMPLS)
def test_strategy_run_matches_jax(sruns, impl, key):
    assert_same_run(sruns[("port", impl)][0][key],
                    sruns[("jax", impl)][0][key], f"{impl} {key}")


@pytest.mark.parametrize("impl", IMPLS)
def test_build_plan_matches_jax(world, sruns, impl):
    """``build_plan`` over each package's own executor-warmed store, for
    every strategy the plan decides alone (``blend`` defers to the
    executor's probe), at each stored CFO and at 0.4."""
    kb, sys_t, q2 = world["kb"], world["sys_t"], world["q2"]
    pstore, jstore = sruns[("port", impl)][1], sruns[("jax", impl)][1]
    chunks = [kb[1], kb[0], kb[3]]
    for name in LEGACY_NAMES:
        for frac in (None, 0.4):
            sel = {}
            plans = {}
            for tag, store, get, build in (
                    ("port", pstore, get_strategy, build_plan),
                    ("jax", jstore, j_get_strategy, j_build_plan)):
                holder = type("Holder", (), {})()
                holder.strategy_obj = get(name)
                recording(holder)
                plans[tag] = build(store, sys_t, chunks, q2,
                                   strategy=holder.strategy_obj,
                                   rng=np.random.default_rng(3),
                                   force_recompute_fraction=frac)
                sel[tag] = dict(selections=holder.selections,
                                strategy=name)
            p, j = plans["port"], plans["jax"]
            assert [d.is_hit for d in p.decisions] == \
                [d.is_hit for d in j.decisions]
            np.testing.assert_allclose([d.cfo for d in p.decisions],
                                       [d.cfo for d in j.decisions],
                                       rtol=0, atol=TOL)
            assert p.num_active_tokens == j.num_active_tokens
            if near_ties(sel["port"], sel["jax"]) == 0:
                for dp, dj in zip(p.decisions, j.decisions):
                    np.testing.assert_array_equal(dp.recompute_idx,
                                                  dj.recompute_idx)
                np.testing.assert_array_equal(p.active_positions,
                                              j.active_positions)


# ---- blend's probe where it measures something: tiny gemma3-4b -------------

@pytest.fixture(scope="module")
def g3runs(tmp_path_factory):
    """``blend`` at 0.3 on tiny gemma3-4b (its first pattern window is
    four layers, three ``local``), its prompt's three chunks rotated, over
    each package's own warmed store: the JAX executor's run, then the
    port's on its choices, on each route."""
    cfg, jcfg = get_tiny("gemma3-4b"), j_tiny("gemma3-4b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    kb = [rng.integers(0, V, 24) for _ in range(3)]
    sys_t, q1, q2 = (rng.integers(0, V, n) for n in (8, 12, 12))
    out = {}
    for impl in IMPLS:
        for name, pkg in (("jax", jax_pkg(jcfg, jparams)),
                          ("port", port_pkg(cfg, tparams))):
            store = new_store(pkg, tmp_path_factory, f"g3-{name}-{impl}")
            pkg.executor(store, use_focus=False, attn_impl=impl).process(
                sys_t, kb, q1)
            ex = recording(pkg.executor(
                store, strategy="blend", use_focus=False, attn_impl=impl,
                force_recompute_fraction=0.3, **RO))
            ref = out.get(("jax", impl))
            out[name, impl] = run(ex, sys_t, [kb[2], kb[0], kb[1]], q2,
                                  None if ref is None else ref["selections"])
            store.tiers.close()
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_blend_probe_matches_jax_on_gemma3(g3runs, impl):
    """Each moved chunk's deviations (hundreds) within NEAR_TIE of the
    reference's, relative to the largest, and its chosen tokens equal;
    the system prompt, in place, deviates by rounding alone in both
    packages. Then the run is held to the reference as every other."""
    mine, ref = g3runs["port", impl], g3runs["jax", impl]
    moved = 0
    for (sa, _fa, ia), (sb, _fb, ib) in zip(mine["selections"],
                                           ref["selections"]):
        a = np.asarray(sa.deviation, np.float64)
        b = np.asarray(sb.deviation, np.float64)
        if b.max() <= ROUNDING_DEV:
            assert a.max() <= ROUNDING_DEV
            continue
        moved += 1
        np.testing.assert_allclose(a, b, rtol=0, atol=NEAR_TIE * b.max())
        np.testing.assert_array_equal(ia, ib)
    assert moved == 3
    assert_same_run(mine, ref, f"gemma3 {impl} blend")


# ---- the shared choice log and near-tie rule -------------------------------

def _log(*idx, scores=(0.9, 0.5, 0.4999, 0.1)):
    """A one-call choice log over ``scores`` (``blend``'s deviation)."""
    return [(SelectScores(deviation=np.asarray(scores)), 0.5,
             np.asarray(idx))]


@pytest.mark.parametrize("case,want", [
    ("equal", (0, 0)),
    ("near tie", (1, 2)),
    ("far", None),
    ("count", None),
    ("noise", (1, 2)),
    ("not ranked", None),
])
def test_selection_ties_rule(case, want):
    """Equal choices pass; a swap of two tokens whose scores sit within
    NEAR_TIE * max of the boundary is one tie of two tokens; a swap across
    a real gap, a different count, or any difference in a strategy that
    does not rank raise; below the rounding floor every order ties."""
    mine, ref, floor = _log(0, 1), _log(0, 1), 0.0
    key = lambda s: s.deviation  # noqa: E731
    if case == "near tie":
        mine = _log(0, 2)
    elif case == "far":
        mine = _log(0, 3)
    elif case == "count":
        mine = _log(0, 1, 2)
    elif case == "noise":
        mine, ref = (_log(0, 3, scores=(5e-13, 4e-13, 1e-13, 3e-13)),
                     _log(0, 1, scores=(5e-13, 4e-13, 1e-13, 3e-13)))
        floor = ROUNDING_DEV
    elif case == "not ranked":
        mine, key = _log(0, 2), (lambda s: None)
    if want is None:
        with pytest.raises(RuntimeError, match="differs"):
            selection_ties(case, mine, ref, key, floor)
    else:
        assert selection_ties(case, mine, ref, key, floor) == want


def test_replay_takes_the_logged_choice(world, tmp_path_factory):
    """A port executor given another run's log plans with that log's
    tokens and logs its own: ``cachecraft`` at 0.3, replayed with each
    chunk's least-scored tokens in place of its top ones."""
    w = world
    store = _warm_store(w, tmp_path_factory, "replay")
    chunks = [w["kb"][1], w["kb"][0], w["kb"][2]]

    def ex():
        return recording(w["port"].executor(
            store, use_focus=False, force_recompute_fraction=0.3, **RO))

    free = run(ex(), w["sys_t"], chunks, w["q2"])
    other = [(sc, f, np.sort(np.argsort(sc.inter, kind="stable")[:len(i)]))
             for sc, f, i in free["selections"]]
    assert any(not np.array_equal(o[2], i)
               for o, (_s, _f, i) in zip(other, free["selections"]))
    got = run(ex(), w["sys_t"], chunks, w["q2"], other)
    assert [c[2].tolist() for c in got["selections"]] == \
        [c[2].tolist() for c in free["selections"]]
    assert [i for h, i in zip(got["hits"], got["idx"]) if h] == \
        [o[2].tolist() for o in other]
    assert not np.array_equal(got["logits"], free["logits"])
    store.tiers.close()


# ---- every strategy through the engine, both packages ----------------------

def _engine_run(pkg, world, tmp, impl, strategy, replay=None):
    """One engine of ``pkg`` with its own fresh store over 8 requests of
    3 chunks (prefill batches of 2, so later batches reuse earlier
    chunks), 4 greedy tokens each, its executor's choices recorded (and
    with ``replay``, another engine's log, taken in place of its own)."""
    port = pkg == "port"
    cfg = world["cfg"] if port else world["jcfg"]
    Store, Tiers = (ChunkStore, TieredStore) if port else (JStore, JTiers)
    store = Store(Tiers(1 << 28, 1 << 28, str(tmp.mktemp(f"{pkg}-eng")),
                        start_worker=False), 50, 4)
    spec = (EngineSpec if port else JSpec)(
        strategy=strategy, use_focus=False, pool_blocks=512, attn_impl=impl,
        sched=(SchedulerConfig if port else JSched)(max_decode_batch=4,
                                                   max_prefill_batch=2),
        trace_decode=True, **(dict(device="cpu") if port else {}))
    eng = (build_engine if port else j_build)(
        spec, cfg=cfg, params=world["tparams" if port else "jparams"],
        store=store)
    recording(eng.executor)
    eng.executor.strategy_obj.replay = None if replay is None else \
        list(replay)
    kb = (KnowledgeBase if port else JKB)(num_chunks=10,
                                          vocab_size=cfg.vocab_size, seed=0)
    reqs = (generate if port else j_generate)(kb, (
        WorkloadConfig if port else JWL)(num_requests=8, qpm=1e9, seed=3,
                                         k_chunks=3, max_new_tokens=4))
    stats = eng.run(reqs)
    assert not eng.executor.strategy_obj.replay, "replayed choices left"
    return eng, stats, reqs


def _per_rid(trace):
    out = {}
    for step in trace:
        for rid, lg in step.items():
            out.setdefault(rid, []).append(np.asarray(lg, np.float32))
    return out


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("impl", IMPLS)
def test_engine_strategy_matches_jax(world, tmp_path_factory, impl,
                                     strategy):
    eng_j, st_j, reqs_j = _engine_run("jax", world, tmp_path_factory,
                                      impl, strategy)
    eng_t, st_t, reqs_t = _engine_run("port", world, tmp_path_factory,
                                      impl, strategy,
                                      eng_j.executor.selections)
    assert st_t.completed == st_j.completed == len(reqs_t)
    assert st_t.failed == st_j.failed == 0
    assert st_t.prefill_tokens_total == st_j.prefill_tokens_total
    assert st_t.prefill_tokens_computed == st_j.prefill_tokens_computed
    for rt, rj in zip(reqs_t, reqs_j):
        assert rt.state == State.DONE and rj.state.name == "DONE"
        assert rt.cache_hits == rj.cache_hits, rt.rid
        assert rt.prefill_tokens_computed == rj.prefill_tokens_computed
    if get_strategy(strategy).needs_store:
        assert any(r.cache_hits > 0 for r in reqs_t)
    ties = near_ties(dict(selections=eng_t.executor.selections,
                          strategy=strategy),
                     dict(selections=eng_j.executor.selections,
                          strategy=strategy))
    if ties:
        print(f"engine {impl} {strategy}: {ties} selection(s) differ at a "
              "near tie; tokens and logits compared on the JAX choices")
    mine, ref = _per_rid(eng_t.decode_trace), _per_rid(eng_j.decode_trace)
    assert set(mine) == set(ref)
    flips = 0
    for rt, rj in zip(reqs_t, reqs_j):
        for i, (a, b) in enumerate(zip(mine[rt.rid], ref[rj.rid])):
            if rt.output_tokens[:i + 1] != rj.output_tokens[:i + 1]:
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] <= TOL, (rt.rid, i)
                flips += 1
                break
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"rid {rt.rid} step {i}")
        else:
            assert rt.output_tokens == rj.output_tokens
    if flips:
        print(f"engine {impl} {strategy}: {flips} greedy flip(s) at a "
              "near tie")


# ---- chip_smoke.py's strategies phase, rehearsed on the CPU ----------------

def test_chip_smoke_strategies_phase_rehearsal(world, tmp_path, monkeypatch):
    """``chip_smoke.run_strategies`` on tiny llama3-8b with
    ``device="cpu"``: the timers stubbed, the chunk and RoPE wrappers
    routed through their launch hooks onto the plain versions (each
    counting its calls), so that the phase's recorders, counts and gates
    run as on the card. The dense route's free ``blend`` choices trade
    their last token for the next-ranked one, a near tie (the deviations
    are rounding on llama3-8b), so that the phase's rerun of dense on the
    kernel's choices runs too."""
    import pathlib

    from repro_torch.core import prefill
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.rope import ops as rops

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    import chip_smoke as cs

    def chunk_launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, C,
                     window):
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=C, window=window,
                                    q_seg=q_seg[b], k_seg=k_seg[b])
                for b in range(q.shape[0])]
        cops.chunk_attention.launches += 1
        return (torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]))

    def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                        k_seg=None, num_chunks=16, window=0):
        return cops._launch(
            q, k, v, q_pos, k_pos, k_chunk,
            torch.zeros_like(q_pos) if q_seg is None else q_seg,
            torch.zeros_like(k_pos) if k_seg is None else k_seg,
            num_chunks, window)
    chunk_attention.launches = 0

    def rope_np(cfg, k, pos, *, device, inverse=False):
        rops.rope.launches += 1
        return rops.rope(torch.from_numpy(np.array(k, np.float32)),
                         torch.from_numpy(np.asarray(pos, np.int32)),
                         theta=cfg.rope_theta, inverse=inverse).numpy()

    record = cs.record_selections

    def record_dense_tie(ex):
        calls = record(ex)
        if ex.attn_impl != "dense" or ex.strategy != "blend":
            return calls
        own = type(ex.strategy_obj).select_tokens

        def select_tokens(self, scores, frac, rng=None):
            idx = own(self, scores, frac, rng)
            if self.replay is None and 0 < len(idx) < len(scores.deviation):
                order = np.argsort(-scores.deviation, kind="stable")
                n = len(idx)
                idx = np.sort(np.append(idx[idx != order[n - 1]], order[n]))
                calls[-1] = calls[-1][:2] + (idx,)
            return idx
        type(ex.strategy_obj).select_tokens = select_tokens
        return calls

    monkeypatch.setattr(cs, "record_selections", record_dense_tie)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cops, "_launch", chunk_launch)
    monkeypatch.setattr(cops, "chunk_attention", chunk_attention)
    monkeypatch.setattr(prefill, "rope_np", rope_np)
    monkeypatch.setattr(rops.rope, "launches", 0)
    with torch.no_grad():
        out = cs.run_strategies(world["cfg"], world["tparams"],
                                str(tmp_path), device="cpu")
    assert all(n > 0 for n in out["launches"].values())
    assert set(out["runs"]) >= set(STRATEGIES)
    for impl, idn in out["identities"].items():
        assert idn["blend 1.0 == all"]["bit_equal"], impl
        assert idn["blend 0.0 == none"]["bit_equal"], impl
        assert idn["forced 1.0 vs all"] <= cs.FORCED_TOL
    assert out["streamed"]["bit_equal"]
    # every segment of every prompt is a hit: a system prompt and 5 chunks
    assert out["runs"]["blend"]["near_tie_calls"] == 6 * cs.STRATEGY_PROMPTS
    assert out["runs"]["blend"]["max_deviation"] <= cs.ROUNDING_DEV
    assert out["probe"]["float32"]["err"] <= 3e-5
    print(json.dumps({k: out[k] for k in ("launches", "chunk_calls",
                                          "focus", "seconds")}))


@pytest.mark.parametrize("impl", IMPLS)
def test_h2o_key_mass_by_route(sruns, impl):
    """``h2o`` ranks by the mass a token receives as a key. Only ``dense``
    returns it; the chunk kernel does not (in both packages, ROADMAP C5),
    so a store warmed on ``kernel`` holds no ``token_total`` and ``h2o``
    falls back to inter mass there, as the reference does."""
    for pkg in ("port", "jax"):
        store = sruns[(pkg, impl)][1]
        totals = [v.scores.token_total for vs in store.table.values()
                  for v in vs]
        assert totals
        if impl == "kernel":
            assert all(t is None for t in totals), pkg
        else:
            assert all(t is not None and np.asarray(t).sum() > 0
                       for t in totals), pkg

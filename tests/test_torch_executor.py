"""The Cache-Craft executor inside the port (the reference's
``tests/test_executor.py``, re-proved on the port) and held against the
JAX executor.

Tiny llama3-8b with the reference's weights (``params_from_jax``), on
the CPU, the reference's inputs (numpy seed 0). The six reference gates
run on the port on the ``dense`` and ``kernel`` routes (the kernel's
``ref.py`` on the CPU): warm-up then hits, forced full recompute within
3e-4 of the oracle, quality improving with the recompute fraction, focus
early termination, the ablation flags (Table 3), an inapplicable arch.

Then every executor run of those gates is made once by each package on
the same route (the reference's ``kernel`` route runs its Pallas kernels
in interpret mode) and compared: the plans (hits, CFO, the recomputed
tokens, active rows, computed and total tokens) and the results
(``logits_last``, ``k_layers``, ``v_layers`` within 2e-4). Each package
plans from its own stored scores, which differ by float noise, so a
selection may differ only at a near tie (chip_smoke.py's
``selection_ties``: the tokens that differ sit within NEAR_TIE of the
selection boundary). The port's runs take the JAX runs' token choices
and log their own (``record_selections``), so that a run with a near tie
is still held to the reference in value; the near ties are counted and
printed. The port's runs are made in a fresh interpreter with the host
BLAS pinned (``run_pinned``, ROADMAP C9)."""
import pickle
import sys
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.prefill import CacheCraftExecutor as JExecutor
from repro.core.tiers import TieredStore as JTiers
from repro.models import model as JM
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.prefill import CacheCraftExecutor
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.metrics import relative_deviation
from test_torch_preempt import ROOT, run_pinned

sys.path.insert(0, ROOT)
from chip_smoke import (NEAR_TIE, ROUNDING_DEV,  # noqa: E402
                        record_selections, selection_ties)
from chip_smoke import ranked_by as cs_ranked_by  # noqa: E402

torch.set_num_threads(2)
TOL = 2e-4
IMPLS = ("dense", "kernel")
RO = dict(store_fixed_variants=False, store_new_chunks=False)
ABLATIONS = {"fixed": dict(fix_rpe=True, fix_causality=True),
             "no_rpe": dict(fix_rpe=False, fix_causality=True),
             "no_causal": dict(fix_rpe=True, fix_causality=False)}


# ---- the two packages behind one interface ---------------------------------

def port_pkg(cfg, params):
    return types.SimpleNamespace(
        name="port", cfg=cfg, params=params, Store=ChunkStore,
        Tiers=TieredStore,
        executor=lambda store, **kw: CacheCraftExecutor(
            cfg, params, store, device="cpu", **kw))


def jax_pkg(cfg, params):
    return types.SimpleNamespace(
        name="jax", cfg=cfg, params=params, Store=JStore, Tiers=JTiers,
        executor=lambda store, **kw: JExecutor(cfg, params, store, **kw))


def new_store(pkg, tmp, tag):
    return pkg.Store(pkg.Tiers(1 << 30, 1 << 30, str(tmp.mktemp(tag)),
                               start_worker=False),
                     n_chunks=20, m_variants=3)


def recording(ex):
    """Log every token choice of ``ex`` in ``ex.selections``
    (``record_selections``)."""
    ex.selections = record_selections(ex)
    return ex


def run(ex, sys_t, chunks, q, replay=None):
    """One ``process`` call -> the figures both packages are compared on
    (the selections are this call's own). With ``replay`` (another run's
    selections) the call takes that run's choices."""
    n0 = len(ex.selections)
    ex.strategy_obj.replay = None if replay is None else list(replay)
    r = ex.process(sys_t, chunks, q)
    left, ex.strategy_obj.replay = ex.strategy_obj.replay, None
    assert not left, f"{len(left)} replayed choices left over"
    plan = r.plan
    return dict(
        hits=[bool(d.is_hit) for d in plan.decisions],
        cfo=[float(d.cfo) for d in plan.decisions],
        idx=[np.asarray(d.recompute_idx).tolist() for d in plan.decisions],
        lengths=[int(d.seg.length) for d in plan.decisions],
        active=int(plan.num_active_tokens), total=int(plan.total_len),
        cached=int(plan.num_cached_tokens),
        active_rows_layers=int(r.active_rows_layers),
        compute_fraction=float(r.compute_fraction),
        recompute_fraction=float(plan.recompute_fraction),
        focus_cutoff=r.focus_cutoff,
        focused=None if r.focused is None else sorted(r.focused),
        logits=np.asarray(r.logits_last, np.float32),
        k=np.asarray(r.k_layers, np.float32),
        v=np.asarray(r.v_layers, np.float32),
        selections=ex.selections[n0:],
        strategy=ex.strategy)


def ranked_by(strategy):
    """The score a strategy ranks a chunk's tokens by
    (``chip_smoke.ranked_by``), and that score's rounding floor."""
    return cs_ranked_by(strategy), \
        ROUNDING_DEV if strategy == "blend" else 0.0


def near_ties(mine, ref):
    """The two runs' selections, call by call: the number of calls that
    differ at a near tie (``selection_ties``, which raises on any other
    difference)."""
    key, floor = ranked_by(ref["strategy"])
    return selection_ties(ref["strategy"], mine["selections"],
                          ref["selections"], key, floor)[0]


def assert_same_run(mine, ref, label=""):
    """Plans equal (near ties aside), values within TOL; ``mine`` ran on
    ``ref``'s choices. Returns the near-tie count."""
    assert mine["hits"] == ref["hits"], label
    np.testing.assert_allclose(mine["cfo"], ref["cfo"], rtol=0, atol=TOL,
                               err_msg=label)
    for key in ("active", "total", "cached", "active_rows_layers",
                "focus_cutoff", "focused"):
        assert mine[key] == ref[key], (label, key, mine[key], ref[key])
    ties = near_ties(mine, ref)
    assert mine["idx"] == ref["idx"], label
    for key in ("logits", "k", "v"):
        np.testing.assert_allclose(mine[key], ref[key], rtol=TOL, atol=TOL,
                                   err_msg=f"{label}: {key}")
    if ties:
        print(f"{label}: {ties} selection(s) differ at a near tie; values "
              "compared on the reference's choices")
    return ties


# ---- the reference's inputs and weights ------------------------------------

def inputs(cfg):
    """The reference's prompts (numpy seed 0)."""
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    kb = [rng.integers(0, V, 24) for _ in range(8)]
    sys_t = rng.integers(0, V, 8)
    q1 = rng.integers(0, V, 12)
    q2 = rng.integers(0, V, 12)
    return dict(kb=kb, sys_t=sys_t, q1=q1, q2=q2)


@pytest.fixture(scope="module")
def world():
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jax=jax_pkg(jcfg, jparams), **inputs(jcfg))


def gate_runs(pkg, w, tmp, impl, ref=None):
    """Every executor run of the reference's gates 1-5, on ``impl``. The
    read-only runs (no store writes) share one store warmed as each gate
    warms its own; the runs that write get their own store, and the
    forced-recompute run, which stores its new chunk, comes last on the
    shared one. With ``ref`` ({run: selections}) each run takes those
    choices."""
    kb, sys_t, q1, q2 = w["kb"], w["sys_t"], w["q1"], w["q2"]
    ex = lambda store, **kw: recording(pkg.executor(  # noqa: E731
        store, attn_impl=impl, use_focus=kw.pop("use_focus", False), **kw))
    reorder, abl_order = [kb[1], kb[0], kb[3]], [kb[1], kb[2], kb[0]]
    out = {}

    def put(key, e, chunks, q):
        out[key] = run(e, sys_t, chunks, q, None if ref is None else ref[key])

    # gate 1: warm-up, then hits
    store = new_store(pkg, tmp, f"{pkg.name}-{impl}-warm")
    e = ex(store)
    put("warmup", e, kb[:3], q1)
    out["warmup_variants"] = store.num_variants()
    put("hits", e, reorder, q2)
    # the store of gates 2, 3 and 5
    shared = new_store(pkg, tmp, f"{pkg.name}-{impl}-shared")
    ex(shared).process(sys_t, kb[:3], q1)
    oracle = ex(None, strategy="all")
    put("oracle", oracle, reorder, q2)
    for frac in (0.0, 0.3, 0.7):
        put(f"frac {frac}", ex(shared, force_recompute_fraction=frac, **RO),
            reorder, q2)
    put("oracle ablation", oracle, abl_order, q2)
    for name, kw in ABLATIONS.items():
        put(name, ex(shared, strategy="none", **RO, **kw), abl_order, q2)
    put("forced 1.0", ex(shared, force_recompute_fraction=1.0,
                         store_fixed_variants=False), reorder, q2)
    # gate 4: focus early termination over four chunks
    fstore = new_store(pkg, tmp, f"{pkg.name}-{impl}-focus")
    ex(fstore).process(sys_t, kb[:4], q1)
    for tag, kw in (("no focus", {}),
                    ("focus", dict(use_focus=True, focus_w=2))):
        put(tag, ex(fstore, force_recompute_fraction=0.5, **RO, **kw),
            kb[:4], q2)
    for s in (store, shared, fstore):
        s.tiers.close()
    return out


RUN_KEYS = ("warmup", "hits", "oracle", "frac 0.0", "frac 0.3", "frac 0.7",
            "oracle ablation", "fixed", "no_rpe", "no_causal", "forced 1.0",
            "no focus", "focus")


class _Tmp:
    """``tmp_path_factory.mktemp`` inside ``tmp`` for a process without
    pytest's fixtures."""

    def __init__(self, tmp):
        self.tmp = tmp

    def mktemp(self, tag):
        return tempfile.mkdtemp(prefix=tag, dir=self.tmp)


def _port_gate_runs(tmp, npz, ref_pkl):
    """{impl: gate_runs} of the port on the reference's weights (``npz``)
    and the JAX runs' choices (``ref_pkl``); run through ``run_pinned``."""
    cfg = get_tiny("llama3-8b")
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    port = port_pkg(cfg, TM.params_from_jax(cfg, leaves, "cpu"))
    with open(ref_pkl, "rb") as f:
        ref = pickle.load(f)
    return {impl: gate_runs(port, inputs(cfg), _Tmp(tmp), impl, ref[impl])
            for impl in IMPLS}


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """{(package, impl): gate_runs}: the JAX executor's runs, then the
    port's on their choices, each package's executor run once."""
    tmp = tmp_path_factory.mktemp("gates")
    out = {("jax", impl): gate_runs(world["jax"], world, tmp_path_factory,
                                    impl) for impl in IMPLS}
    npz, ref_pkl = tmp / "params.npz", tmp / "ref.pkl"
    np.savez(npz, params=np.array(jax.tree.map(np.asarray,
                                               world["jax"].params),
                                  dtype=object))
    with open(ref_pkl, "wb") as f:
        pickle.dump({impl: {k: [(None, c[1], c[2]) for c in
                                out[("jax", impl)][k]["selections"]]
                            for k in RUN_KEYS} for impl in IMPLS}, f)
    port = run_pinned(__name__, tmp, "_port_gate_runs", str(tmp), str(npz),
                      str(ref_pkl))
    out.update({("port", impl): r for impl, r in port.items()})
    return out


# ---- the reference's gates, on the port ------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_warmup_then_hits(runs, impl):
    r = runs[("port", impl)]
    assert r["warmup"]["compute_fraction"] == pytest.approx(1.0)
    assert r["warmup_variants"] == 4            # sys + 3 chunks
    assert sum(r["hits"]["hits"]) == 3
    assert r["hits"]["compute_fraction"] < 1.0
    assert r["hits"]["recompute_fraction"] < 1.0


@pytest.mark.parametrize("impl", IMPLS)
def test_forced_full_recompute_is_exact(runs, impl):
    r = runs[("port", impl)]
    np.testing.assert_allclose(r["forced 1.0"]["logits"],
                               r["oracle"]["logits"], rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_quality_improves_with_recompute(runs, impl):
    r = runs[("port", impl)]
    devs = {f: relative_deviation(r[f"frac {f}"]["logits"],
                                  r["oracle"]["logits"])
            for f in (0.0, 0.3, 0.7)}
    assert devs[0.7] < devs[0.0]
    assert devs[0.3] <= devs[0.0] + 1e-6


@pytest.mark.parametrize("impl", IMPLS)
def test_focus_early_termination_reduces_compute(runs, impl):
    r = runs[("port", impl)]
    rf, rn = r["focus"], r["no focus"]
    if rf["focus_cutoff"] is not None and rf["focused"] is not None and \
            len(rf["focused"]) < 4:
        assert rf["active_rows_layers"] < rn["active_rows_layers"]


@pytest.mark.parametrize("impl", IMPLS)
def test_ablation_flags_change_output(runs, impl):
    """Table 3: without the RPE fix the reuse path deviates more from the
    oracle than with both fixes."""
    r = runs[("port", impl)]
    dev = {name: relative_deviation(r[name]["logits"],
                                    r["oracle ablation"]["logits"])
           for name in ABLATIONS}
    assert dev["no_rpe"] > dev["fixed"]


def test_inapplicable_arch_raises():
    cfg = get_tiny("mamba2-370m")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TM.init_params(cfg, gen)
    with pytest.raises(ValueError, match="inapplicable"):
        CacheCraftExecutor(cfg, params, store="not-none",  # type: ignore
                           device="cpu")


# ---- every run of those gates, against the JAX executor --------------------

@pytest.mark.parametrize("key", RUN_KEYS)
@pytest.mark.parametrize("impl", IMPLS)
def test_gate_run_matches_jax(runs, impl, key):
    assert_same_run(runs[("port", impl)][key], runs[("jax", impl)][key],
                    f"{impl} {key}")


@pytest.mark.parametrize("impl", IMPLS)
def test_gate_outcomes_match_jax(runs, impl):
    """The figures the gates assert on, side by side: the variants after
    warm-up, the deviations behind the quality and ablation orderings."""
    p, j = runs[("port", impl)], runs[("jax", impl)]
    assert p["warmup_variants"] == j["warmup_variants"]
    for oracle, keys in (("oracle", ("frac 0.0", "frac 0.3", "frac 0.7",
                                     "forced 1.0")),
                         ("oracle ablation", tuple(ABLATIONS))):
        for k in keys:
            dp = relative_deviation(p[k]["logits"], p[oracle]["logits"])
            dj = relative_deviation(j[k]["logits"], j[oracle]["logits"])
            assert dp == pytest.approx(dj, rel=1e-2, abs=TOL), (k, dp, dj)

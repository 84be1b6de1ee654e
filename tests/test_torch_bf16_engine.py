"""The rest of the engine in bf16, the port against the reference: every
recompute strategy and the executor's options, the engine under pool
pressure, quantized tiers and the HTTP server, each on ``kernel`` (the
only route the reference serves in bf16, ROADMAP C12) with tiny llama3-8b
in ``cfg.replace(dtype="bfloat16", param_dtype="bfloat16")``: bf16
weights and activations over the fp32 caches of the executor, the arena
and the pool, the reference's bf16 weights carried across by
``params_from_jax``. The JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.

The tolerances are those of the bf16 serving and bf16 step tests
(``tests/test_torch_bf16_serving.py``, ``tests/test_torch_bf16_steps.py``;
their docstrings argue them):

* values the executor returns (last logits, K and V): the bf16 rule
  (``tests/test_torch_bf16_steps.py`` ``held``): the rms gap to the
  reference's bf16 value within 2x the reference's own rms bf16-vs-fp32
  gap, the largest within 2x its largest plus one bf16 ulp. The
  yardstick is the reference's fp32 deployment on the same bf16-rounded
  weights, its own store warmed in fp32, replaying the bf16 run's token
  choices;
* decode logits and greedy tokens (``BF16_GAP_FACTOR``): the
  port's decode logits within 2x the reference's bf16-vs-fp32 decode gap
  while the tokens agree, and a token may part only at a step where the
  reference's top-two gap is within that tolerance;
* token choices: equal, or a near tie (``chip_smoke.selection_ties``)
  whose band adds the bf16 floor, 2x the gap between the reference's bf16
  and fp32 scores of the call. The port replays the reference's choices,
  so every run is held in value (``record_selections``). In bf16
  ``blend``'s probe deviations are bf16 rounding (the layer-0 K/V
  recomputed in bf16 against the stored fp32 K/V of a bf16 run), not the
  1e-13 of C11, so its choices tie everywhere.

Pool pressure (ROADMAP C3): a preempted request re-prefills packed beside
another partner, and in bf16 the packing moves the bits by one rounding,
which at a near tie moves a greedy token. The gates hold the pressured
run to the unpressured one up to such a step, and a control shows the
cause: the unpressured workload with the parted request packed with its
pressured partners reproduces the pressured trajectory byte for byte.

``-s`` prints every gap, tie and parting; ``-k rehearsal`` runs
chip_smoke.py's phase 21 on tiny llama3-8b on the CPU, clean and with one
layer's bf16 decode output zeroed, which must raise.
"""
import collections
import json
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import StoreSpec as JStoreSpec
from repro.serving.api import build_engine as j_build
from repro.serving.api import build_store as j_build_store
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_tiny
from repro_torch.core.strategies import STRATEGIES
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, StoreSpec, build_engine, \
    build_store
from repro_torch.serving.metrics import relative_deviation
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.server import CacheCraftServer, ServeClient
from repro_torch.serving.workload import WorkloadConfig, generate
from test_torch_bf16_serving import BF16_GAP_FACTOR, C12_ROUTES, _fp32
from test_torch_bf16_steps import held
from test_torch_executor import inputs, jax_pkg, new_store, port_pkg, \
    recording
from test_torch_preempt import ROOT, finish_pinned, start_pinned

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(2)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
RO = dict(store_fixed_variants=False, store_new_chunks=False)
CASES = dict(cs.strategy_cases())
CHURN = (18, 18, 3, 5, 4, 6)           # the reference's churn workload
TIMEOUT = 30.0                          # every server read


@pytest.fixture(scope="module")
def world():
    cfg32, jcfg32 = get_tiny("llama3-8b"), j_tiny("llama3-8b")
    jcfg16 = jcfg32.replace(**BF16)
    jp16 = JM.init_params(jcfg16, jax.random.PRNGKey(0))
    tp16 = TM.params_from_jax(cfg32.replace(**BF16),
                              jax.tree.map(np.asarray, jp16), "cpu")
    return types.SimpleNamespace(
        cfg16=cfg32.replace(**BF16), cfg32=cfg32, tp16=tp16,
        tp32=_fp32(tp16), jcfg16=jcfg16, jcfg32=jcfg32, jp16=jp16,
        jp32=jax.tree.map(lambda x: x.astype(jnp.float32), jp16))


def _side(w, pkg, dt):
    """(cfg, params) of one package in one dtype."""
    return {("port", 16): (w.cfg16, w.tp16), ("port", 32): (w.cfg32, w.tp32),
            ("jax", 16): (w.jcfg16, w.jp16),
            ("jax", 32): (w.jcfg32, w.jp32)}[pkg, dt]


def _f32(x):
    return np.asarray(x, np.float32)


def _gap(a, b):
    return float(np.abs(_f32(a) - _f32(b)).max())


def _ties(tag, strategy, mine, ref, ref32):
    """``selection_ties`` of two choice logs with the bf16 floor: 2x
    the reference's bf16-vs-fp32 score gap (``ref32``'s own scores)."""
    key = cs.ranked_by(strategy)
    floor = BF16_GAP_FACTOR * cs.score_gap(ref, ref32, key)
    return cs.selection_ties(tag, mine, ref, key, floor) + (floor,)


# ---------------------------------------------------------------------------
# (a, c) the executor: phase 17's cases, each package on its own store
# ---------------------------------------------------------------------------
def _pkg(w, pkg, dt):
    c, p = _side(w, pkg, dt)
    return (port_pkg if pkg == "port" else jax_pkg)(c, p)


def _executor(w, pkg, dt, store, **kw):
    return recording(_pkg(w, pkg, dt).executor(
        store, attn_impl="kernel", use_focus=False,
        rng=np.random.default_rng(0), **kw))


def _evals(x):
    """Two prompts packed in one pass: the reference's reordered prompt
    with a novel chunk, and a rotation of the stored one."""
    kb = x["kb"]
    return [(x["sys_t"], [kb[1], kb[0], kb[3]], x["q2"]),
            (x["sys_t"], [kb[2], kb[0], kb[1]], x["q1"])]


def _xrun(ex, evals, replay=None):
    """One ``process_batch`` -> its plans, values and this call's choices
    (with ``replay``, another run's choices taken)."""
    n0 = len(ex.selections)
    ex.strategy_obj.replay = None if replay is None else list(replay)
    out = ex.process_batch(evals)
    left, ex.strategy_obj.replay = ex.strategy_obj.replay, None
    assert not left, f"{len(left)} replayed choices left over"
    return dict(
        hits=[bool(d.is_hit) for r in out for d in r.plan.decisions],
        cfo=[float(d.cfo) for r in out for d in r.plan.decisions],
        idx=[np.asarray(d.recompute_idx).tolist()
             for r in out for d in r.plan.decisions],
        counts=[(int(r.plan.num_active_tokens), int(r.plan.total_len),
                 int(r.plan.num_cached_tokens), int(r.active_rows_layers))
                for r in out],
        logits=np.stack([_f32(r.logits_last) for r in out]),
        k=[_f32(r.k_layers) for r in out], v=[_f32(r.v_layers) for r in out],
        streamed=[bool(r.streamed) for r in out],
        loads=sum(r.load_blocked_layers + r.load_hidden_layers for r in out),
        selections=ex.selections[n0:])


@pytest.fixture(scope="module")
def xruns(world, tmp_path_factory):
    """{(package, dtype): {case: run}}: each (package, dtype) warms its own
    store on ``kernel`` with the reference's warm-up prompt, then every
    case only reads it; the reference's bf16 runs choose, the others
    replay those choices. The port in bf16 also runs ``cachecraft`` with
    streamed loads."""
    x = inputs(world.cfg16)
    evals = _evals(x)
    out = {}
    for pkg, dt in (("jax", 16), ("jax", 32), ("port", 16)):
        store = new_store(_pkg(world, pkg, dt), tmp_path_factory,
                          f"{pkg}{dt}")
        _executor(world, pkg, dt, store).process(x["sys_t"], x["kb"][:3],
                                                 x["q1"])
        runs = out[pkg, dt] = {}
        for name, kw in CASES.items():
            ref = None if (pkg, dt) == ("jax", 16) else \
                out["jax", 16][name]["selections"]
            runs[name] = _xrun(_executor(world, pkg, dt, store, **RO, **kw),
                               evals, ref)
        if pkg == "port":
            runs["streamed"] = _xrun(
                _executor(world, pkg, dt, store, layerwise_load=True, **RO,
                          **CASES["cachecraft"]),
                evals, out["jax", 16]["cachecraft"]["selections"])
        store.tiers.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_executor_case_matches_jax_bf16(xruns, case):
    """Plans equal (choices only at near ties), CFOs by the bf16 rule,
    the last logits and every layer's K and V by the bf16 rule."""
    mine, ref = xruns["port", 16][case], xruns["jax", 16][case]
    ref32 = xruns["jax", 32][case]
    strategy = CASES[case].get("strategy", "cachecraft")
    assert mine["hits"] == ref["hits"]
    assert any(mine["hits"]) == (strategy != "all")
    assert mine["idx"] == ref["idx"] and mine["counts"] == ref["counts"]
    ties, tokens, floor = _ties(case, strategy, mine["selections"],
                                ref["selections"], ref32["selections"])
    cfo_gap, cfo_ref = _gap(mine["cfo"], ref["cfo"]), \
        _gap(ref["cfo"], ref32["cfo"])
    assert cfo_gap <= BF16_GAP_FACTOR * cfo_ref or cfo_gap == 0.0, \
        (case, cfo_gap, cfo_ref)
    gaps = {}
    for what in ("logits", "k", "v"):
        got, want, yard = (np.concatenate([np.ravel(a) for a in r[what]])
                           for r in (mine, ref, ref32))
        ok, g, r, gm, rm = held(got, want, yard)
        gaps[what] = (g, r, gm, rm)
        assert ok, (case, what, g, r, gm, rm)
    print(f"executor bf16 {case}: port vs reference, rms (yardstick) / "
          "largest (yardstick): " + ", ".join(
              f"{n} {g:.2e} ({r:.2e}) / {gm:.2e} ({rm:.2e})"
              for n, (g, r, gm, rm) in gaps.items())
          + f"; CFO {cfo_gap:.2e} ({cfo_ref:.2e}); {ties} selection(s), "
          f"{tokens} token(s) at a near tie (floor {floor:.3e})")


def test_executor_identities_bf16(xruns):
    """Inside the port in bf16: blend@1 == all and blend@0 == none byte
    for byte, streamed == eager byte for byte, forced full recompute
    within FORCED_TOL of ``all``, the deviation from ``all`` at 0.7 below
    that at 0, and without the RPE fix above that with it."""
    runs = xruns["port", 16]
    for got, want in (("blend 1.0", "all"), ("blend 0.0", "none"),
                      ("streamed", "cachecraft")):
        for key in ("logits", "k", "v"):
            for a, b in zip(*(np.atleast_1d(runs[n][key]) if key == "logits"
                              else runs[n][key] for n in (got, want))):
                np.testing.assert_array_equal(a, b, err_msg=f"{got} {key}")
    s = runs["streamed"]
    assert all(s["streamed"]) and s["loads"] == \
        get_tiny("llama3-8b").num_layers * sum(s["hits"])
    fg = _gap(runs["forced 1.0"]["logits"], runs["all"]["logits"])
    dev = {n: float(np.mean([relative_deviation(a, b) for a, b in zip(
        runs[n]["logits"], runs["all"]["logits"])]))
        for n in ("frac 0.0", "frac 0.7", "none", "no_rpe")}
    print(f"port bf16: forced 1.0 vs all {fg:.3e} (FORCED_TOL "
          f"{cs.FORCED_TOL}); deviation from all {dev}")
    assert fg <= cs.FORCED_TOL
    assert dev["frac 0.7"] < dev["frac 0.0"]
    assert dev["no_rpe"] > dev["none"]


# ---------------------------------------------------------------------------
# (b, e, f) engines: the reference in bf16 chooses, its fp32 run and the
# port replay; logits and tokens by the greedy rule (``hold_greedy``)
# ---------------------------------------------------------------------------
def _kb(pkg, cfg, n):
    return (KnowledgeBase if pkg == "port" else JKB)(
        num_chunks=n, vocab_size=cfg.vocab_size, seed=0)


def _workload(pkg, cfg, n_req=8, seed=3):
    """8 requests of 3 chunks from a 10-chunk knowledge base, 4 tokens
    each (``tests/test_torch_strategies.py``'s engine workload)."""
    return (generate if pkg == "port" else j_generate)(
        _kb(pkg, cfg, 10), (WorkloadConfig if pkg == "port" else JWL)(
            num_requests=n_req, qpm=1e9, seed=seed, k_chunks=3,
            max_new_tokens=4))


def _engine(w, pkg, dt, store=None, replay=None, **kw):
    c, p = _side(w, pkg, dt)
    port = pkg == "port"
    spec = (EngineSpec if port else JSpec)(
        use_focus=False, pool_blocks=512, attn_impl="kernel",
        sched=(SchedulerConfig if port else JSched)(max_decode_batch=4,
                                                   max_prefill_batch=2),
        trace_decode=True, **kw, **(dict(device="cpu") if port else {}))
    eng = (build_engine if port else j_build)(spec, cfg=c, params=p,
                                              store=store)
    eng.executor.selections = cs.record_selections(eng.executor)
    eng.executor.strategy_obj.replay = None if replay is None else \
        list(replay)
    return eng


def _trace_prefills(eng):
    """Record the last logits of every prefill of ``eng`` (either
    package), by rid, in ``eng.prefill_logits``."""
    eng.prefill_logits, rids = {}, []
    run_prefills, process = eng._run_prefills, eng.executor.process_batch

    def run(reqs):
        rids[:] = [r.rid for r in reqs]
        return run_prefills(reqs)

    def process_batch(prompts):
        out = process(prompts)
        for rid, r in zip(rids, out):
            eng.prefill_logits.setdefault(rid, []).append(
                _f32(r.logits_last))
        return out
    eng._run_prefills, eng.executor.process_batch = run, process_batch
    return eng


def traced(eng, reqs):
    """{rid: the logits that chose each of its tokens}: its last
    prefill's, then the decode steps of its last attempt (a preempted
    request's discarded attempts come first in the decode trace)."""
    dec = {}
    for step in eng.decode_trace:
        for rid, lg in step.items():
            dec.setdefault(rid, []).append(_f32(lg))
    out = {}
    for r in reqs:
        steps = dec.get(r.rid, [])
        out[r.rid] = [eng.prefill_logits[r.rid][-1]] + \
            steps[len(steps) - (len(r.output_tokens) - 1):]
    return out


def _engine_run(w, pkg, dt, reqs, store=None, replay=None, **kw):
    eng = _trace_prefills(_engine(w, pkg, dt, store, replay, **kw))
    stats = eng.run(reqs)
    assert not eng.executor.strategy_obj.replay, "replayed choices left"
    return dict(stats=stats, reqs=reqs, sel=eng.executor.selections,
                trace=traced(eng, reqs),
                tokens={r.rid: list(r.output_tokens) for r in reqs},
                eng=eng)


def _logit_gap(a, b):
    """Largest gap of two runs' logits (``traced``) over the steps whose
    inputs agree (the tokens before them equal)."""
    worst = 0.0
    for rid in b["trace"]:
        for i, (x, y) in enumerate(zip(a["trace"][rid], b["trace"][rid])):
            if a["tokens"][rid][:i] != b["tokens"][rid][:i]:
                break
            worst = max(worst, _gap(x, y))
    return worst


def hold_greedy(tag, mine, ref, tol):
    """The greedy rule on two runs' logits (``traced``): request by request,
    the logits within ``tol`` while the inputs agree, and a token may part
    only at a step whose reference top-two gap is within ``tol``; the
    request is compared no further. Returns (largest gap, the partings as
    (rid, token, top-two gap), requests compared whole)."""
    worst, parts, whole = 0.0, [], 0
    assert set(mine["trace"]) == set(ref["trace"]), tag
    for rid, steps in ref["trace"].items():
        for i, (a, b) in enumerate(zip(mine["trace"][rid], steps)):
            worst = max(worst, _gap(a, b))
            if int(a.argmax()) != int(b.argmax()):
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] <= tol, (tag, rid, i, top2)
                parts.append((rid, i, float(top2[1] - top2[0])))
                break
        else:
            assert mine["tokens"][rid] == ref["tokens"][rid], (tag, rid)
            whole += 1
    assert worst <= tol, (tag, worst, tol)
    return worst, parts, whole


def _hold_engines(tag, t16, j16, j32):
    """Counts and per-request plans equal, choices at near ties only,
    logits and tokens by the greedy rule; prints the figures."""
    st_t, st_j = t16["stats"], j16["stats"]
    assert st_t.completed == st_j.completed == len(t16["reqs"])
    assert st_t.failed == st_j.failed == 0
    for k in ("prefill_tokens_total", "prefill_tokens_computed",
              "prefill_batches", "decode_steps"):
        assert getattr(st_t, k) == getattr(st_j, k), (tag, k)
    for rt, rj in zip(t16["reqs"], j16["reqs"]):
        assert rt.state == State.DONE and rj.state.name == "DONE"
        assert (rt.cache_hits, rt.prefill_tokens_computed) == \
            (rj.cache_hits, rj.prefill_tokens_computed), (tag, rt.rid)
    strategy = t16["eng"].executor.strategy
    ties, tokens, floor = _ties(tag, strategy, t16["sel"], j16["sel"],
                                j32["sel"])
    tol = BF16_GAP_FACTOR * _logit_gap(j16, j32)
    worst, parts, whole = hold_greedy(tag, t16, j16, tol)
    print(f"{tag}: logits {worst:.3e} (tol {tol:.3e}), partings "
          f"{parts}, {whole}/{len(t16['reqs'])} requests whole; {ties} "
          f"selection(s), {tokens} token(s) at a near tie (floor "
          f"{floor:.3e}); computed / total prefill tokens "
          f"{st_t.prefill_tokens_computed} / {st_t.prefill_tokens_total}")
    return st_t


def _three(w, tmp, tag, store=None, **kw):
    """The reference in bf16, in fp32 on its choices, the port in bf16 on
    its choices; with ``store`` (``StoreSpec`` fields) each over its own
    store of 50 chunks and 4 variants (``tests/test_torch_strategies.py``'s
    engine runs)."""
    runs = {}
    for pkg, dt in (("jax", 16), ("jax", 32), ("port", 16)):
        c = _side(w, pkg, dt)[0]
        st = None if store is None else \
            (build_store if pkg == "port" else j_build_store)(
                (StoreSpec if pkg == "port" else JStoreSpec)(
                    ssd_dir=str(tmp.mktemp(f"{tag}-{pkg}{dt}")),
                    n_chunks=50, m_variants=4, start_worker=False, **store))
        runs[pkg, dt] = _engine_run(
            w, pkg, dt, _workload(pkg, c), st,
            None if (pkg, dt) == ("jax", 16) else runs["jax", 16]["sel"],
            **kw)
        if st is not None:
            st.tiers.close()
    return runs


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_engine_strategy_matches_jax_bf16(world, tmp_path_factory,
                                          strategy):
    runs = _three(world, tmp_path_factory, strategy,
                  None if strategy == "all" else {}, strategy=strategy)
    st = _hold_engines(f"engine bf16 {strategy}", runs["port", 16],
                       runs["jax", 16], runs["jax", 32])
    if strategy not in ("all", "none", "prefix"):
        assert st.prefill_tokens_computed < st.prefill_tokens_total


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_quantized_tier_engine_matches_jax_bf16(world, tmp_path_factory,
                                                codec):
    """A store whose HBM tier holds a few chunks, its CPU and SSD tiers
    encoded with ``codec``: hits load from the quantized tiers in both
    packages alike (dequantizing loads and bytes saved equal)."""
    runs = _three(world, tmp_path_factory, codec,
                  dict(hbm_bytes=1 << 16,
                       tier_dtypes={"cpu": codec, "ssd": codec}),
                  strategy="cachecraft")
    st = _hold_engines(f"engine bf16 {codec} tiers", runs["port", 16],
                       runs["jax", 16], runs["jax", 32])
    st_j = runs["jax", 16]["stats"]
    assert st.tier_dequant_loads == st_j.tier_dequant_loads > 0
    assert st.tier_quant_bytes_saved == st_j.tier_quant_bytes_saved > 0
    print(f"{codec}: {st.tier_dequant_loads} dequantizing loads, "
          f"{st.tier_quant_bytes_saved} bytes saved")


# ---------------------------------------------------------------------------
# (f) the HTTP server around a bf16 engine
# ---------------------------------------------------------------------------
def _server_requests(cfg, n, max_new, cls=Request):
    """``tests/test_torch_server.py``'s requests: two chunks each."""
    kb = KnowledgeBase(num_chunks=12, vocab_size=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(5)
    V = kb.vocab_size
    return [cls(rid=i, system_tokens=rng.integers(0, V, 8).astype(np.int32),
                chunk_tokens=[kb.chunks[(2 * i) % 12].copy(),
                              kb.chunks[(2 * i + 1) % 12].copy()],
                question_tokens=rng.integers(0, V, 10).astype(np.int32),
                max_new_tokens=max_new, arrival_time=0.0)
            for i in range(n)]


def _server_engine(w, pkg="port", dt=16):
    c, p = _side(w, pkg, dt)
    port = pkg == "port"
    spec = (EngineSpec if port else JSpec)(
        strategy="all", use_focus=False, pool_blocks=512, attn_impl="kernel",
        sched=(SchedulerConfig if port else JSched)(
            max_batch_tokens=100_000, max_decode_batch=4,
            max_prefill_batch=1),
        trace_decode=True, **(dict(device="cpu") if port else {}))
    return (build_engine if port else j_build)(spec, cfg=c, params=p,
                                               store=None)


def test_server_bf16_streams_equal_offline_and_cancel(world):
    """Streams over a real socket byte-identical to an offline run of the
    same bf16 engine spec; one stream cancelled after its 2nd token ends
    a strict prefix of its offline run, the others unchanged, no block
    reserved after the drain."""
    n, max_new = 3, 12
    ref = _server_requests(world.cfg16, n, max_new)
    _server_engine(world).run(ref)
    server = CacheCraftServer(_server_engine(world)).start()
    try:
        client = ServeClient(server.host, server.port, timeout=TIMEOUT)
        assert client.health()["ok"]
        reqs = _server_requests(world.cfg16, n, max_new)
        rids = [client.submit(r) for r in reqs]
        got = {}

        def reader(rid):
            got[rid] = client.stream(rid)
        threads = []
        for rid in rids[1:]:
            t = threading.Thread(target=reader, args=(rid,), daemon=True)
            t.start()
            threads.append(t)
        acc = []

        def on_token(tok):
            acc.append(tok)
            if len(acc) == 2:
                client.cancel(rids[0])
        toks, state = client.stream(rids[0], on_token=on_token)
        for t in threads:
            t.join(timeout=2 * TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert state == State.CANCELLED.value and 2 <= len(toks) < max_new
        assert toks == ref[0].output_tokens[:len(toks)]
        for rid in rids[1:]:
            assert got[rid] == (ref[rid].output_tokens, State.DONE.value)
        stats = client.stats()
        assert stats["cancelled"] == 1
        assert stats["pool"]["reserved_blocks"] == 0
        assert stats["server"]["inflight"] == 0
    finally:
        server.shutdown()
    assert not server._thread.is_alive()


def test_server_bf16_streams_match_jax(world):
    """The bf16 server's streams against the reference's offline bf16
    engine on the same requests, by the greedy rule (its yardstick the
    reference's fp32 engine on the same weights)."""
    n, max_new = 4, 6
    jruns = {}
    for dt in (16, 32):
        eng = _trace_prefills(_server_engine(world, "jax", dt))
        reqs = _server_requests(world.jcfg16, n, max_new, JRequest)
        eng.run(reqs)
        jruns[dt] = dict(trace=traced(eng, reqs),
                         tokens={r.rid: list(r.output_tokens) for r in reqs})
    eng = _trace_prefills(_server_engine(world))
    reqs = _server_requests(world.cfg16, n, max_new)
    server = CacheCraftServer(eng).start()
    try:
        client = ServeClient(server.host, server.port, timeout=TIMEOUT)
        got = {}

        def reader(rid):
            got[rid] = client.stream(rid)
        threads = []
        for r in reqs:
            t = threading.Thread(target=reader, args=(client.submit(r),),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=2 * TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
    assert all(s == State.DONE.value for _t, s in got.values())
    streams = [types.SimpleNamespace(rid=rid, output_tokens=t)
               for rid, (t, _s) in got.items()]
    mine = dict(trace=traced(eng, streams),
                tokens={r.rid: r.output_tokens for r in streams})
    tol = BF16_GAP_FACTOR * _logit_gap(jruns[16], jruns[32])
    worst, parts, whole = hold_greedy("server bf16", mine, jruns[16], tol)
    print(f"server bf16 vs the reference's offline bf16 engine: "
          f"logits {worst:.3e} (tol {tol:.3e}), partings {parts}, "
          f"{whole}/{n} streams whole")
    assert whole >= 1


# ---------------------------------------------------------------------------
# (d) the engine under pool pressure, in fresh interpreters
# ---------------------------------------------------------------------------
def _churn(cfg, params, pool, after, pack=2, keep=None):
    """The churn workload (seed 17) on a bf16 ``kernel`` engine; ``keep``:
    only those requests, all arriving at 0 (so that they pack as one
    pass)."""
    eng = cs.churn_engine(cfg, params, pool, after, pack, device="cpu",
                          attn_impl="kernel")
    groups = cs._prefill_groups(eng)
    _trace_prefills(eng)
    reqs = cs._churn_requests(cfg, CHURN, 17)
    if keep is not None:
        reqs = [r for r in reqs if r.rid in keep]
        for r in reqs:
            r.arrival_time = 0.0
    stats = eng.run(reqs)
    c, pool_ = eng.counters, eng.pool
    return dict(
        completed=stats.completed, failed=stats.failed,
        states=[r.state.value for r in reqs], groups=groups,
        trace=traced(eng, reqs), final_kv=eng.final_kv,
        tokens={r.rid: list(r.output_tokens) for r in reqs},
        counters={k: getattr(c, k) for k in (
            "preemptions", "preempt_block_recovered", "burn_requeues")},
        pool=dict(reserved=pool_.reserved_blocks, live=pool_.live_blocks,
                  free=pool_.free_blocks, blocks=pool_.num_blocks))


def _pressure_runs(npz, tmp, gates):
    """The port's pressure runs on the reference's bf16 weights: the
    churn workload at pool 512 and at pool 20 (preempting after 4 stalled
    iterations), the unpacked control (every request prefilled alone, no
    pressure) and, for each request whose tokens part, the unpressured
    workload cut to that request's last pressured prefill pass, packed as
    it was. With ``gates``: zero-copy against copy, incremental against
    rebuild."""
    cfg = get_tiny("llama3-8b").replace(**BF16)
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    params = TM.params_from_jax(cfg, leaves, "cpu")
    out = {"512": _churn(cfg, params, 512, 0),
           "20": _churn(cfg, params, 20, 4),
           "unpacked": _churn(cfg, params, 512, 0, pack=1), "partners": {}}
    for rid, toks in out["512"]["tokens"].items():
        if toks != out["20"]["tokens"][rid]:
            grp = next(g for g in out["20"]["groups"][::-1] if rid in g)
            out["partners"][rid] = _churn(cfg, params, 512, 0, keep=grp)
    if gates:
        kw = dict(device="cpu", attn_impl="kernel")
        out["zero_copy"] = cs.zero_copy_runs("bf16", cfg, params, tmp, **kw)
        out["incremental"] = cs.incremental_runs("bf16", cfg, params, **kw)
    return out


@pytest.fixture(scope="module", autouse=True)
def port_pressure(world, tmp_path_factory):
    """The port's pressure runs in fresh interpreters, started with the
    module's first test so that they run beside the in-process tests: the
    gates' runs with the host BLAS pinned (ROADMAP C9), and the churn runs
    with the host BLAS in its default mode on one thread (C9's flake is
    gone there too, and its products follow the packed shape)."""
    tmp = tmp_path_factory.mktemp("pressure16")
    npz = tmp / "params.npz"
    np.savez(npz, params=np.array(jax.tree.map(np.asarray, world.jp16),
                                  dtype=object))
    started = {"pinned": start_pinned(
        "test_torch_bf16_engine", tmp, "_pressure_runs", str(npz), str(tmp),
        True), "default": start_pinned(
        "test_torch_bf16_engine", tmp, "_pressure_runs", str(npz), str(tmp),
        False, pin=False, threads=1)}
    yield started
    for proc, _out, err in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


@pytest.fixture(scope="module")
def pressure(world, port_pressure):
    """The port's runs (``port_pressure``) and the reference's churn runs
    on ``kernel``: bf16 at pool 512 and 20, fp32 at 512 (the
    yardstick)."""
    ref = {}
    for tag, dt, pool, after in (("512", 16, 512, 0), ("20", 16, 20, 4),
                                 ("512 fp32", 32, 512, 0)):
        c, p = _side(world, "jax", dt)
        eng = _trace_prefills(j_build(JSpec(
            strategy="all", use_focus=False, pool_blocks=pool,
            decode_bucket_b=4, seq_bucket=512, attn_impl="kernel",
            sched=JSched(max_batch_tokens=100_000, max_decode_batch=4,
                         max_prefill_batch=2, preempt_after_iters=after),
            trace_decode=True), cfg=c, params=p, store=None))
        reqs = j_generate(JKB(num_chunks=10, vocab_size=c.vocab_size,
                              seed=0),
                          JWL(num_requests=6, qpm=1e9, seed=17, k_chunks=3,
                              max_new_tokens=4))
        for r, n in zip(reqs, CHURN):
            r.max_new_tokens = n
        st = eng.run(reqs)
        ref[tag] = dict(trace=traced(eng, reqs),
                        tokens={r.rid: list(r.output_tokens) for r in reqs},
                        completed=st.completed,
                        preemptions=eng.counters.preemptions)
    return {k: finish_pinned(v) for k, v in port_pressure.items()}, ref


@pytest.mark.parametrize("blas", ["pinned", "default"])
def test_pressured_bf16_run_matches_unpressured(pressure, blas):
    """Preemptions, 6 done, none failed, the pool settled; the pressured
    logits within the bf16 tolerance (2x the reference's bf16-vs-fp32 gap
    on the unpressured run) of the unpressured run's while the tokens
    agree, and a token parted only where the unpressured top-two gap is
    within it. The reference's two runs, compared the same way, stand
    beside it."""
    port, ref = pressure
    u, p = port[blas]["512"], port[blas]["20"]
    assert u["counters"]["preemptions"] == 0
    assert p["counters"]["preemptions"] > 0
    assert p["counters"]["burn_requeues"] == 0
    assert u["completed"] == p["completed"] == 6
    assert u["failed"] == p["failed"] == 0
    assert all(s == State.DONE.value for s in p["states"])
    assert p["pool"] == dict(reserved=0, live=0, free=20, blocks=20)
    tol = BF16_GAP_FACTOR * _logit_gap(ref["512"], ref["512 fp32"])
    worst, parts, whole = hold_greedy(f"pressure bf16 {blas}", p, u, tol)
    assert ref["20"]["preemptions"] > 0
    rworst, rparts, rwhole = hold_greedy("reference pressure bf16",
                                         ref["20"], ref["512"], tol)
    print(f"pressure bf16, host BLAS {blas} (tol {tol:.3e}): port pool 20 "
          f"vs 512 {worst:.3e}, partings {parts}, {whole}/6 whole; the "
          f"reference's {rworst:.3e}, partings {rparts}, {rwhole}/6 whole")


def test_pressured_bf16_parting_is_packing(pressure):
    """ROADMAP C3 in bf16. With the host BLAS in its default mode a
    request's tokens part under pressure. It was prefilled in another
    pass: the unpressured workload cut to that pass's requests, packed as
    they were, reproduces its pressured trajectory byte for byte (tokens,
    the logits of every token, final KV), and the unpacked control
    reproduces the unpressured one. So the packing partner, not
    preemption, moves its bits; with the host BLAS pinned the packed shape
    moves nothing here, and no request parts."""
    port, _ref = pressure
    run = port["default"]
    u, p, alone = run["512"], run["20"], run["unpacked"]
    parted = [rid for rid in u["tokens"] if u["tokens"][rid] !=
              p["tokens"][rid]]
    assert parted and sorted(run["partners"]) == parted
    assert port["pinned"]["partners"] == {}
    for rid in parted:
        ctl = run["partners"][rid]
        assert ctl["tokens"][rid] == p["tokens"][rid]
        assert len(ctl["trace"][rid]) == len(p["trace"][rid])
        for a, b in zip(ctl["trace"][rid], p["trace"][rid]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ctl["final_kv"][rid], p["final_kv"][rid]):
            np.testing.assert_array_equal(a, b)
        assert alone["tokens"][rid] == u["tokens"][rid]
        for a, b in zip(alone["trace"][rid], u["trace"][rid]):
            np.testing.assert_array_equal(a, b)
        gaps = [_gap(a, b) for a, b in zip(p["trace"][rid],
                                           u["trace"][rid])]
        top2 = [float(np.diff(np.sort(b)[-2:])[0]) for b in u["trace"][rid]]
        print(f"rid {rid}: unpressured {u['tokens'][rid]} (prefill pass "
              f"{[g for g in u['groups'] if rid in g]}), pressured "
              f"{p['tokens'][rid]} (pass "
              f"{[g for g in p['groups'] if rid in g]}); the packed control "
              f"reproduces the pressured run; pressured vs unpressured "
              f"logits by token {np.round(gaps, 4).tolist()}, unpressured "
              f"top-two gaps {np.round(top2, 4).tolist()}")


def test_zero_copy_equals_copy_bf16(pressure):
    """Zero-copy sharing against the copy path in bf16: the same tokens,
    decode logits byte for byte, segments shared."""
    (fc, trc, tokc, _kc), (fz, trz, tokz, _kz) = \
        (pressure[0]["pinned"]["zero_copy"][s] for s in (False, True))
    assert fz["shared_seg_hits"] > 0 and fc["shared_seg_hits"] == 0
    assert tokz == tokc
    assert cs._trace_gap(trz, trc) == (0.0, True)


def test_incremental_equals_rebuild_bf16(pressure):
    """The incremental decode batch against rebuilds in bf16: the same
    tokens, decode logits and final KV byte for byte."""
    (fi, tri, toki, kvi), (fr, trr, tokr, kvr) = \
        (pressure[0]["pinned"]["incremental"][i] for i in (True, False))
    assert fi["decode_rebuilds"] == 1 and fr["decode_rebuilds"] > 1
    assert toki == tokr
    assert cs._trace_gap(tri, trr) == (0.0, True)
    assert cs.kv_gap("incremental", kvi, kvr) == (0.0, True)


# ---------------------------------------------------------------------------
# (g) C12 at the executor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attn_impl", sorted({r for r, _p in C12_ROUTES
                                              if r not in (None, "kernel")}))
def test_c12_executor_routes_refused_in_both(world, tmp_path_factory,
                                             attn_impl):
    """The port's executor refuses a bf16 model on every route but
    ``kernel`` when it is built; the reference's executor fails on the
    same route in its first pass (fp32 attention into the bf16
    residual)."""
    x = inputs(world.cfg16)
    port, ref = _pkg(world, "port", 16), _pkg(world, "jax", 16)
    with pytest.raises(ValueError, match="C12"):
        port.executor(new_store(port, tmp_path_factory, "c12"),
                      attn_impl=attn_impl)
    ex = ref.executor(new_store(ref, tmp_path_factory, "c12j"),
                      attn_impl=attn_impl, use_focus=False)
    with pytest.raises(TypeError, match="carry input and carry output"):
        ex.process(x["sys_t"], x["kb"][:3], x["q1"])


# ---------------------------------------------------------------------------
# (h) chip_smoke.py's phase 21, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _route_wrappers(mp, plant):
    """The chunk and decode wrappers through their launch hooks onto the
    plain versions, each counting its launches by instantiation as on the
    card; ``prefill.rope_np`` through the RoPE wrapper, counted. While
    ``plant["on"]``, layer 0's bf16 decode output is zeroed."""
    from repro_torch.core import prefill
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.serving import api

    L = get_tiny("llama3-8b").num_layers

    def chunk_launch(q, k, v, q_pos, k_pos, k_chunk, q_seg, k_seg, C,
                     window):
        outs = [chunk_attention_ref(q[b], k[b], v[b], q_pos[b], k_pos[b],
                                    k_chunk[b], num_chunks=C, window=window,
                                    q_seg=q_seg[b], k_seg=k_seg[b])
                for b in range(q.shape[0])]
        f = cops.chunk_attention
        f.launches += 1
        f.launches_by_type[build.ATTN_TYPE_NAMES[
            build.attn_type_code("chunk", q, k, v)]] += 1
        return (torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]))

    def chunk_attention(q, k, v, q_pos, k_pos, k_chunk, *, q_seg=None,
                        k_seg=None, num_chunks=16, window=0):
        return cops._launch(
            q, k, v, q_pos, k_pos, k_chunk,
            torch.zeros_like(q_pos) if q_seg is None else q_seg,
            torch.zeros_like(k_pos) if k_seg is None else k_seg,
            num_chunks, window)

    def call(what, entry, ptrs, ints, q, nsplit):
        return decode_attention_ref(*ptrs, window=ints[-1])

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        B, H, D = q.shape
        decode_attention.launches += 1
        decode_attention.launches_by_type[build.ATTN_TYPE_NAMES[
            build.attn_type_code("decode", q, k, v)]] += 1
        out = dops._call("decode_attention", "decode_attention_fwd",
                         (q, k, v, q_pos, k_pos),
                         (B, k.shape[1], H, k.shape[2], D, int(window)),
                         q, 1)
        if plant["on"] and q.dtype == torch.bfloat16:
            plant["calls"] += 1
            if (plant["calls"] - 1) % L == 0:
                out = torch.zeros_like(out)
        return out

    def rope_np(cfg, k, pos, *, device, inverse=False):
        rops.rope.launches += 1
        return rops.rope(torch.from_numpy(np.array(k, np.float32)),
                         torch.from_numpy(np.asarray(pos, np.int32)),
                         theta=cfg.rope_theta, inverse=inverse).numpy()

    for f in (chunk_attention, decode_attention):
        f.launches, f.launches_by_type = 0, collections.Counter()
    spec_cls = api.EngineSpec
    mp.setattr(api, "EngineSpec",
               lambda **kw: spec_cls(**{**kw, "device": "cpu"}))
    mp.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3: (fn(), 1.0)[1])
    mp.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3, windows=3:
               (fn(), 1.0)[1])
    for name in ("synchronize", "reset_peak_memory_stats"):
        mp.setattr(torch.cuda, name, lambda *a, **k: None)
    mp.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    mp.setattr(cops, "_launch", chunk_launch)
    mp.setattr(cops, "chunk_attention", chunk_attention)
    mp.setattr(dops, "_call", call)
    mp.setattr(dops, "decode_attention", decode_attention)
    mp.setattr(prefill, "rope_np", rope_np)
    mp.setattr(rops.rope, "launches", 0, raising=False)


@pytest.fixture(scope="module")
def rehearsal(world, tmp_path_factory):
    """Phase 19 then phase 21 on tiny llama3-8b (the reference's weights,
    whose churn run parts a request under pressure), clean; then phase 21
    again with layer 0's bf16 decode output zeroed."""
    tmp = tmp_path_factory.mktemp("rehearsal")
    cfg = get_tiny("llama3-8b")
    params = _fp32(world.tp16)
    plant = dict(on=False, calls=0)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        _route_wrappers(mp, plant)
        bf16 = cs.run_bf16(cfg, params, str(tmp / "p19"))
        clean = cs.run_bf16_engine(cfg, params, bf16, str(tmp / "clean"),
                                   device="cpu")
        plant["on"] = True
        try:
            cs.run_bf16_engine(cfg, params, bf16, str(tmp / "planted"),
                               device="cpu")
            fault = None
        except RuntimeError as e:
            fault = str(e)
    return clean, fault


def test_chip_smoke_bf16_engine_phase_rehearsal(rehearsal):
    out, _fault = rehearsal
    assert out["launches"]["chunk_attention"] == \
        {cs.MIXED: out["want"]["chunk_attention"]}
    assert out["launches"]["decode_attention"] == \
        {cs.MIXED: out["want"]["decode_attention"]}
    assert out["launches"]["rope_dtypes"] == \
        {"float32": out["launches"]["rope"]}
    runs = out["strategies"]["runs"]
    assert set(runs) == set(CASES)
    assert all(r["ratio"] <= 1.0 for r in runs.values())
    idn = out["strategies"]["identities"]
    assert idn["blend 1.0 == all"]["bit_equal"]
    assert idn["blend 0.0 == none"]["bit_equal"]
    assert idn["streamed == eager"]["bit_equal"]
    probe = out["strategies"]["probe"]
    assert probe[cs.MIXED]["ratio"] <= 1.0
    assert probe["float32"]["err"] <= cs.TOL["float32"]
    pr = out["pressure"]["preempt"]
    assert pr["pressured"]["preemptions"] > 0
    assert sorted(pr["controls"]) == pr["near_tie_cut"]
    assert all(c["reproduces"] for c in pr["controls"].values())
    assert out["pressure"]["zero_copy"]["bit_equal"]
    assert out["pressure"]["incremental"]["bit_equal"]
    assert out["server"]["survivors_done"] == 11
    json.dumps({k: out[k] for k in ("strategies", "pressure", "server",
                                    "launches", "want")})
    print(f"rehearsal: strategies bf16 vs fp32 ratios "
          f"{ {n: round(r['ratio'], 3) for n, r in runs.items()} }, "
          f"identities {idn}, pressure {pr['bf16_vs_fp32']}, parted "
          f"{pr['near_tie_cut']}, controls {pr['controls']}, server "
          f"{out['server']['survivors_equal_offline_A']}/11 equal to A16, "
          f"launches {out['launches']}")


def test_chip_smoke_bf16_engine_phase_refuses_fault(rehearsal):
    _out, fault = rehearsal
    assert fault is not None and "bf16 vs fp32 decode logits" in fault, \
        fault

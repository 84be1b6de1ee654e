"""Streamed == eager inside the port (the reference's bit-identity gate,
re-proved in the port): layer-granular streamed tier loads
(``layerwise_load=True``, which re-ropes each layer's KV on its own
through ``inject_chunk_kv``) give the same bytes as the eager path that
re-ropes all layers at once, on tiny llama3-8b on the CPU.

Then the rest of the reference's streamed-load and prefetch gates
(``tests/test_cache_manager.py``): the streamed prefill overlaps loads
with compute, the engine accounts the measured overlap, and an expired
request cancels its prefetch."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.prefill import CacheCraftExecutor
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import SchedulerConfig

torch.set_num_threads(2)
KW = dict(use_focus=False, force_recompute_fraction=0.25,
          store_fixed_variants=False, store_new_chunks=False)


@pytest.fixture(scope="module")
def tiny_world():
    cfg = get_tiny("llama3-8b")
    jparams = JM.init_params(j_tiny("llama3-8b"), jax.random.PRNGKey(0))
    params = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                "cpu")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    kb = [rng.integers(0, V, 24) for _ in range(6)]
    sys_t = rng.integers(0, V, 8)
    q1 = rng.integers(0, V, 12)
    q2 = rng.integers(0, V, 12)
    return cfg, params, kb, sys_t, q1, q2


def _warm_store(cfg, params, tmp_path, tag, kb, sys_t, q1,
                start_worker=True):
    ts = TieredStore(1 << 30, 1 << 30, str(tmp_path / tag),
                     start_worker=start_worker)
    store = ChunkStore(ts, n_chunks=20, m_variants=3)
    CacheCraftExecutor(cfg, params, store, use_focus=False,
                       store_fixed_variants=False, device="cpu").process(
        sys_t, kb[:3], q1)
    return store


def test_streamed_prefill_bit_equals_eager(tiny_world, tmp_path):
    cfg, params, kb, sys_t, q1, q2 = tiny_world
    store = _warm_store(cfg, params, tmp_path, "ex", kb, sys_t, q1)
    try:
        reorder = [kb[1], kb[0], kb[2]]
        re = CacheCraftExecutor(cfg, params, store, device="cpu",
                                **KW).process(sys_t, reorder, q2)
        rs = CacheCraftExecutor(cfg, params, store, layerwise_load=True,
                                device="cpu", **KW).process(sys_t, reorder,
                                                            q2)
        assert rs.streamed and not re.streamed
        hits = sum(d.is_hit for d in rs.plan.decisions)
        assert hits > 0
        assert rs.load_blocked_layers + rs.load_hidden_layers \
            == cfg.num_layers * hits
        np.testing.assert_array_equal(re.logits_last, rs.logits_last)
        np.testing.assert_array_equal(re.k_layers, rs.k_layers)
        np.testing.assert_array_equal(re.v_layers, rs.v_layers)
    finally:
        store.tiers.close()


def test_streamed_engine_bit_equals_eager(tiny_world, tmp_path):
    """Through the engine: the same greedy tokens and the same per-step
    decode logits, bit for bit, with and without streamed loads."""
    cfg, params, kb, sys_t, q1, q2 = tiny_world

    def run(tag, layerwise):
        store = _warm_store(cfg, params, tmp_path, tag, kb, sys_t, q1)
        try:
            eng = build_engine(
                EngineSpec(layerwise_load=layerwise, pool_blocks=512,
                           trace_decode=True, device="cpu", **KW),
                cfg=cfg, params=params, store=store)
            reqs = [Request(rid=i, system_tokens=sys_t,
                            chunk_tokens=[kb[1], kb[0], kb[2 + i]],
                            question_tokens=q2 if i else q1,
                            max_new_tokens=4, arrival_time=0.0)
                    for i in range(3)]
            eng.run(reqs)
            return eng, reqs
        finally:
            store.tiers.close()

    eng_e, reqs_e = run("eager", False)
    eng_s, reqs_s = run("streamed", True)
    c = eng_s.counters
    assert c.preload_layers_blocked + c.preload_layers_hidden > 0
    assert eng_e.counters.preload_layers_blocked \
        + eng_e.counters.preload_layers_hidden == 0
    for re, rs in zip(reqs_e, reqs_s):
        assert re.state == rs.state == State.DONE
        assert re.output_tokens == rs.output_tokens
        assert len(rs.output_tokens) == 4
    assert len(eng_e.decode_trace) == len(eng_s.decode_trace) > 0
    for te, tst in zip(eng_e.decode_trace, eng_s.decode_trace):
        assert set(te) == set(tst)
        for rid in te:
            np.testing.assert_array_equal(te[rid], tst[rid])


def test_streamed_prefill_overlaps_load_with_compute(tiny_world, tmp_path):
    """Prefill compute of early layers starts while layers beyond the
    preload depth are still loading (loads from the CPU tier, an injected
    per-layer delay, Eq. 16's compute input pinned so the depth is 1)."""
    cfg, params, kb, sys_t, q1, q2 = tiny_world
    store = _warm_store(cfg, params, tmp_path, "ovl", kb, sys_t, q1)
    ts = store.tiers
    try:
        ex = CacheCraftExecutor(cfg, params, store, layerwise_load=True,
                                device="cpu", **KW)
        reorder = [kb[1], kb[0], kb[2]]
        ex.process(sys_t, reorder, q2)         # settle the compute EMA
        ex.process(sys_t, reorder, q2)
        ts.caps["hbm"] = 1                     # loads come from the CPU tier
        ts.flush()
        ts.load_delay_s = 2e-3
        ex._t_layer_s = 1.0
        t0 = time.perf_counter()
        rs = ex.process(sys_t, reorder, q2)
        wall = time.perf_counter() - t0
        assert rs.streamed and rs.load_trace is not None
        # the interval union of the layer loads never exceeds the wall
        assert rs.load_seconds_measured <= wall + 1e-6, \
            (rs.load_seconds_measured, wall)
        windows = rs.load_trace["windows"]
        assert len(windows) == cfg.num_layers  # one await point a layer
        lp = rs.preload_depth_used
        assert lp == 1
        t_first = windows[0][2]
        late = [l for tr in rs.load_trace["streams"]
                for ev, l, t in tr if ev == "loaded" and t > t_first]
        assert any(l > lp for l in late), (lp, late)
        assert rs.load_exposed_measured >= 0.0
    finally:
        ts.close()


def test_engine_accounts_measured_overlap(tiny_world, tmp_path):
    """With streaming on, the engine's clock takes the executor's measured
    exposure and its counters the hidden / blocked split; the look-ahead
    prefetches both requests."""
    cfg, params, kb, sys_t, q1, q2 = tiny_world
    store = _warm_store(cfg, params, tmp_path, "eng", kb, sys_t, q1)
    try:
        eng = build_engine(
            EngineSpec(layerwise_load=True, pool_blocks=512, device="cpu",
                       **KW), cfg=cfg, params=params, store=store)
        reqs = [Request(rid=i, system_tokens=sys_t,
                        chunk_tokens=[kb[1], kb[0], kb[2]],
                        question_tokens=q2, max_new_tokens=2,
                        arrival_time=0.0) for i in range(2)]
        eng.run(reqs)
        assert all(r.state == State.DONE for r in reqs)
        c = eng.counters
        assert c.preload_layers_blocked + c.preload_layers_hidden > 0
        assert c.prefetch_issued == 2
        assert eng.stats.load_exposed_s >= 0.0
    finally:
        store.tiers.close()


def test_engine_cancels_prefetch_on_expiry(tiny_world, tmp_path):
    """Expiring a queued request retracts its pending tier promotions,
    counted on the engine and on the tier store."""
    cfg, params, kb, sys_t, q1, q2 = tiny_world
    store = _warm_store(cfg, params, tmp_path, "exp", kb, sys_t, q1,
                        start_worker=False)
    ts = store.tiers
    try:
        # max_decode_batch=0 keeps the request queued (admission defers)
        eng = build_engine(
            EngineSpec(use_focus=False, store_fixed_variants=False,
                       store_new_chunks=False, pool_blocks=512,
                       device="cpu",
                       sched=SchedulerConfig(deadline_s=1.0,
                                             max_decode_batch=0)),
            cfg=cfg, params=params, store=store)
        req = Request(rid=0, system_tokens=sys_t, chunk_tokens=[kb[0]],
                      question_tokens=q2, max_new_tokens=2,
                      arrival_time=0.0)
        eng.submit(req)

        def pending():
            return sum(q.unfinished_tasks for q in ts._qs.values())
        assert pending() == 0                  # prefetch is step-driven
        eng.step()                             # the look-ahead promotes
        assert eng.counters.prefetch_issued == 1
        assert pending() > 0
        eng.clock = 10.0                       # past the deadline
        eng.step()                             # the straggler guard fires
        assert req.state == State.FAILED
        assert eng.counters.prefetch_cancels == 1
        ts.drain()
        assert ts.stats["prefetch_cancelled"] > 0
    finally:
        ts.close()

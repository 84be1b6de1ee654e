"""Streamed == eager inside the port (the reference's bit-identity gate,
re-proved in the port): layer-granular streamed tier loads
(``layerwise_load=True``, which re-ropes each layer's KV on its own
through ``inject_chunk_kv``) give the same bytes as the eager path that
re-ropes all layers at once, on tiny llama3-8b on the CPU."""
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


def _warm_store(cfg, params, tmp_path, tag, kb, sys_t, q1):
    ts = TieredStore(1 << 30, 1 << 30, str(tmp_path / tag))
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

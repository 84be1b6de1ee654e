"""The slice as a whole: the port's ``Engine.run`` against the JAX
``Engine.run`` on the same ``generate(...)`` trace, tiny llama3-8b, the
same weights (``params_from_jax``) and identically seeded chunk stores.

The port runs its ``kernel`` backend (chunk-attention prefill windows +
decode kernel; plain versions on the CPU) and the paged ``paged_kernel``
route; the JAX engine runs ``dense`` (the cheap oracle: the JAX kernels
are held against ``dense`` by the reference's own tests). Compared:
per-request output tokens, per-step decode logits at 2e-4, plan outcomes
(hits, computed / total prefill tokens) and completed/failed counts.

Port-internal bit-identities: paged (``paged``) == arena, and packed ==
sequential prefill (the reference's gates, re-proved inside the port).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.tiers import TieredStore as JTiers
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.prefill import CacheCraftExecutor
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.kvpool import BlockTable, KVPool
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
N_REQ, MAX_NEW = 8, 4


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    return cfg, jcfg, tparams, jparams


def _wl(mod_wl):
    return mod_wl(num_requests=N_REQ, qpm=1e9, seed=3, k_chunks=3,
                  max_new_tokens=MAX_NEW)


def _port_run(world, tmp_path, tag, **kw):
    cfg, _jcfg, tparams, _jp = world
    store = ChunkStore(TieredStore(1 << 28, 1 << 28, str(tmp_path / tag),
                                   start_worker=False), 50, 4)
    spec = EngineSpec(use_focus=False, pool_blocks=512, device="cpu",
                      sched=SchedulerConfig(max_decode_batch=4),
                      trace_decode=True, **kw)
    eng = build_engine(spec, cfg=cfg, params=tparams, store=store)
    kb = KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(kb, _wl(WorkloadConfig))
    stats = eng.run(reqs)
    return eng, stats, reqs


@pytest.fixture(scope="module")
def jax_run(world, tmp_path_factory):
    _cfg, jcfg, _tp, jparams = world
    d = tmp_path_factory.mktemp("jstore")
    store = JStore(JTiers(1 << 28, 1 << 28, str(d), start_worker=False),
                   50, 4)
    eng = j_build(JSpec(use_focus=False, pool_blocks=512, attn_impl="dense",
                        sched=JSched(max_decode_batch=4),
                        trace_decode=True),
                  cfg=jcfg, params=jparams, store=store)
    kb = JKB(num_chunks=10, vocab_size=jcfg.vocab_size, seed=0)
    reqs = j_generate(kb, _wl(JWL))
    stats = eng.run(reqs)
    return eng, stats, reqs


@pytest.fixture(scope="module")
def port_kernel(world, tmp_path_factory):
    return _port_run(world, tmp_path_factory.mktemp("pk"), "s",
                     attn_impl="kernel")


@pytest.fixture(scope="module")
def port_paged_kernel(world, tmp_path_factory):
    return _port_run(world, tmp_path_factory.mktemp("ppk"), "s",
                     attn_impl="paged_kernel", paged_decode=True)


def _assert_matches_jax(port, jax_run):
    eng_t, stats_t, reqs_t = port
    eng_j, stats_j, reqs_j = jax_run
    assert stats_t.completed == stats_j.completed == N_REQ
    assert stats_t.failed == stats_j.failed == 0
    assert stats_t.prefill_tokens_total == stats_j.prefill_tokens_total
    assert stats_t.prefill_tokens_computed == stats_j.prefill_tokens_computed
    assert stats_t.prefill_tokens_computed < stats_t.prefill_tokens_total
    for rt, rj in zip(reqs_t, reqs_j):
        assert rt.state == State.DONE and rj.state.name == "DONE"
        assert rt.cache_hits == rj.cache_hits
        assert rt.prefill_tokens_computed == rj.prefill_tokens_computed
        assert rt.output_tokens == rj.output_tokens
    assert len(eng_t.decode_trace) == len(eng_j.decode_trace) > 0
    for step, (tt, tj) in enumerate(zip(eng_t.decode_trace,
                                        eng_j.decode_trace)):
        assert set(tt) == set(tj), f"step {step}: membership differs"
        for rid in tt:
            np.testing.assert_allclose(
                tt[rid], np.asarray(tj[rid]), **TOL,
                err_msg=f"step {step}, rid {rid}")


def test_port_kernel_engine_matches_jax_dense(port_kernel, jax_run):
    _assert_matches_jax(port_kernel, jax_run)
    eng = port_kernel[0]
    assert any(r.cache_hits > 0 for r in port_kernel[2])
    assert eng.pool.reserved_blocks == 0


def test_port_paged_kernel_engine_matches_jax_dense(port_paged_kernel,
                                                    jax_run):
    _assert_matches_jax(port_paged_kernel, jax_run)
    c = port_paged_kernel[0].counters
    assert c.decode_gather_bytes == 0 and c.paged_block_syncs > 0


def test_port_paged_bit_identical_to_arena(world, tmp_path):
    """Port-internal gate: the ``paged`` route (slot-row gather + dense
    oracle over the pool twin) == the arena route, bit for bit, in decode
    logits and final pool KV, with zero gather bytes."""
    eng_a, stats_a, reqs_a = _port_run(world, tmp_path, "a",
                                       attn_impl="dense")
    eng_p, stats_p, reqs_p = _port_run(world, tmp_path, "p",
                                       attn_impl="paged", paged_decode=True)
    assert stats_a.completed == stats_p.completed == N_REQ
    for ra, rp in zip(reqs_a, reqs_p):
        assert ra.output_tokens == rp.output_tokens
    assert len(eng_a.decode_trace) == len(eng_p.decode_trace) > 0
    for ta, tp in zip(eng_a.decode_trace, eng_p.decode_trace):
        assert set(ta) == set(tp)
        for rid in ta:
            np.testing.assert_array_equal(ta[rid], tp[rid])
    for rid in eng_a.final_kv:
        for xa, xp in zip(eng_a.final_kv[rid], eng_p.final_kv[rid]):
            np.testing.assert_array_equal(xa, xp)
    assert eng_a.counters.decode_gather_bytes > 0
    assert eng_p.counters.decode_gather_bytes == 0


def _warm_store(world, tmp_path, tag, kb, sys_a, sys_b, q1, q2):
    cfg, _jcfg, tparams, _jp = world
    store = ChunkStore(TieredStore(1 << 30, 1 << 30, str(tmp_path / tag),
                                   start_worker=False), n_chunks=20,
                       m_variants=3)
    warm = CacheCraftExecutor(cfg, tparams, store, use_focus=False,
                              device="cpu")
    warm.process(sys_a, kb[:2], q2)
    warm.process(sys_b, kb[2:4], q1)
    return store


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_port_packed_matches_sequential(world, tmp_path, impl):
    """Port-internal gate: a 2-request packed prefill pass equals two
    sequential single-request passes (plans, focus, logits, pool KV)."""
    cfg, _jcfg, tparams, _jp = world
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    kb = [rng.integers(0, V, 24) for _ in range(6)]
    sys_a, sys_b = rng.integers(0, V, 8), rng.integers(0, V, 8)
    q1, q2 = rng.integers(0, V, 12), rng.integers(0, V, 10)
    r1, r2 = (sys_a, kb[:2], q1), (sys_b, kb[2:4], q2)
    kw = dict(use_focus=True, focus_w=2, store_fixed_variants=False,
              store_new_chunks=False, attn_impl=impl, device="cpu")
    warm = (kb, sys_a, sys_b, q1, q2)
    ex_seq = CacheCraftExecutor(cfg, tparams, _warm_store(
        world, tmp_path, f"seq{impl}", *warm), **kw)
    res_seq = [ex_seq.process(*r1), ex_seq.process(*r2)]
    ex_pkd = CacheCraftExecutor(cfg, tparams, _warm_store(
        world, tmp_path, f"pkd{impl}", *warm), **kw)
    res_pkd = ex_pkd.process_batch([r1, r2])
    for rs, rp in zip(res_seq, res_pkd):
        assert [d.is_hit for d in rp.plan.decisions] == \
            [d.is_hit for d in rs.plan.decisions]
        assert rp.plan.num_active_tokens == rs.plan.num_active_tokens
        assert rp.focused == rs.focused
        assert rp.focus_cutoff == rs.focus_cutoff
        assert rp.active_rows_layers == rs.active_rows_layers
        np.testing.assert_allclose(rp.logits_last, rs.logits_last, **TOL)
        pool_s = KVPool(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_,
                        64, 16)
        pool_p = KVPool(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_,
                        64, 16)
        ts, tp = BlockTable(), BlockTable()
        assert pool_s.write_prefill(ts, rs.k_layers, rs.v_layers,
                                    rs.pos_layout)
        assert pool_p.write_prefill(tp, rp.k_layers, rp.v_layers,
                                    rp.pos_layout)
        ks, vs, ps = pool_s.gather(ts, 64)
        kp, vp, pp = pool_p.gather(tp, 64)
        np.testing.assert_array_equal(ps, pp)
        np.testing.assert_allclose(kp, ks, **TOL)
        np.testing.assert_allclose(vp, vs, **TOL)


def test_port_engine_packs_prefills_same_tokens(world):
    """Engine-level packed == serial: the same greedy outputs whether the
    scheduler packs 4 prefills per pass or admits one at a time."""
    cfg, _jcfg, tparams, _jp = world
    kb = KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0)
    wl = WorkloadConfig(num_requests=6, qpm=1e9, seed=4, max_new_tokens=3)

    def run(max_pack):
        eng = build_engine(
            EngineSpec(strategy="all", use_focus=False, pool_blocks=2048,
                       attn_impl="kernel", device="cpu",
                       sched=SchedulerConfig(max_batch_tokens=100_000,
                                             max_decode_batch=8,
                                             max_prefill_batch=max_pack)),
            cfg=cfg, params=tparams, store=None)
        reqs = generate(kb, wl)
        return eng.run(reqs), reqs

    stats_p, reqs_p = run(4)
    stats_s, reqs_s = run(1)
    assert stats_p.prefill_batch_max >= 2 and stats_s.prefill_batch_max == 1
    assert stats_p.completed == stats_s.completed == 6
    for rp, rs in zip(reqs_p, reqs_s):
        assert rp.output_tokens == rs.output_tokens

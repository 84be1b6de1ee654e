"""Zero-copy chunk-cache sharing inside the port's KVPool (the
reference's ``tests/test_shared_chunks.py``, re-proved on the port), and
the zero-copy workload held against the JAX engine.

Tiny llama3-8b with the reference's weights (``params_from_jax``), on
the three routes the engine serves: ``default`` (``attn_impl=None``),
``kernel`` and ``paged_kernel`` with ``paged_decode=True`` (their
kernels' ``ref.py`` on the CPU). Zero-copy == copy is byte-equal on the
default and ``kernel`` routes: both write-backs launch the same prefill
windows and the same decode arena. On ``paged_kernel`` it is held to
``KERNEL_TOL`` (2e-4, ROADMAP C3): the zero-copy table aligns every
segment to a block, so its block rows are longer (NBmax) and the paged
decode sums over another number of keys.

Every comparison of copy with zero-copy runs in a fresh interpreter
(``run_pinned``) with the host BLAS pinned to its reproducible mode
(``MKL_CBWR=COMPATIBLE``, ROADMAP C9): without the pin the host's fp32
products in a process are now and then ~1e-4 off, and the store hands
such a product from the first warm-up run on to every later run.
"""
import pathlib

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
from repro.serving.engine import EngineStats as JStats
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSched
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.scoring import ChunkScores
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.engine import EngineStats
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import SchedulerConfig
from test_torch_preempt import run_pinned

torch.set_num_threads(2)

ROUTES = {
    "default": dict(attn_impl=None),
    "kernel": dict(attn_impl="kernel"),
    "paged_kernel": dict(attn_impl="paged_kernel", paged_decode=True),
}
# paged_kernel: zero-copy block rows are longer than the copy path's
KERNEL_TOL = 2e-4
JAX_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    return cfg, tparams, kb, jcfg, jparams


def _store(tmp_path, name, store_cls=ChunkStore, tiers_cls=TieredStore):
    return store_cls(tiers_cls(1 << 28, 1 << 28,
                               str(tmp_path / f"tiers-{name}"),
                               start_worker=False),
                     n_chunks=50, m_variants=4)


def _overlap_requests(kb, n, max_new=4, request_cls=Request):
    """n requests over the same system prompt and chunk list (distinct
    questions): every chunk hit is shareable across all of them."""
    rng = np.random.default_rng(17)
    sys_t = rng.integers(0, kb.vocab_size, 8).astype(np.int32)
    chunks = [kb.chunks[0], kb.chunks[1], kb.chunks[2]]
    return [request_cls(rid=i, system_tokens=sys_t,
                        chunk_tokens=[c.copy() for c in chunks],
                        question_tokens=rng.integers(
                            0, kb.vocab_size, 10).astype(np.int32),
                        max_new_tokens=max_new, arrival_time=0.0)
            for i in range(n)]


def _dense_kv(gathered):
    """(k, v, pos) pool gather -> padding-free arrays ordered by logical
    position (layouts differ between copy and zero-copy tables)."""
    k, v, pos = gathered
    idx = np.where(pos >= 0)[0]
    order = idx[np.argsort(pos[idx], kind="stable")]
    return k[:, order], v[:, order], pos[order]


def _zc_run(cfg, params, kb, tmp_path, route, share):
    """The :66 workload: two warm-up runs (populate, then hit and pin
    pool runs), counters reset, the measured run."""
    store = _store(tmp_path, f"eq-{route}-{share}")
    eng = build_engine(
        EngineSpec(use_focus=False, store_fixed_variants=False,
                   force_recompute_fraction=0.3, pool_blocks=256,
                   sched=SchedulerConfig(max_batch_tokens=100_000,
                                         max_decode_batch=8,
                                         max_prefill_batch=4),
                   share_chunk_kv=share, trace_decode=True, device="cpu",
                   **ROUTES[route]),
        cfg=cfg, params=params, store=store)
    eng.run(_overlap_requests(kb, 4))
    eng.run(_overlap_requests(kb, 4))
    eng.clock = 0.0
    eng.stats = EngineStats()
    eng.counters.reset()
    eng.decode_trace = []
    eng.final_kv = {}
    reqs = _overlap_requests(kb, 4)
    stats = eng.run(reqs)
    return eng, stats, reqs


def _summary(eng, stats, reqs):
    c = eng.counters
    runs = eng.store.residency.runs.values() \
        if eng.store.residency is not None else []
    return dict(
        completed=stats.completed, failed=stats.failed,
        decode_steps=stats.decode_steps,
        states=[r.state for r in reqs],
        outputs=[list(r.output_tokens) for r in reqs],
        hits=[r.cache_hits for r in reqs],
        computed=[r.prefill_tokens_computed for r in reqs],
        trace=eng.decode_trace,
        final_kv={rid: _dense_kv(g) for rid, g in eng.final_kv.items()},
        counters={k: getattr(c, k) for k in (
            "shared_seg_hits", "shared_blocks_peak", "cow_clones",
            "blocks_reserved_total", "live_blocks_peak",
            "delta_blocks_saved")},
        runs=len(runs), live_blocks=eng.pool.live_blocks,
        run_blocks=sum(len(r.blocks) for r in runs),
        readers=[r.readers for r in runs])


def _zc_runs(npz, tmp):
    """The copy run, then the zero-copy run, of the :66 workload on each
    route."""
    cfg = get_tiny("llama3-8b")
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    params = TM.params_from_jax(cfg, leaves, "cpu")
    kb = KnowledgeBase(num_chunks=8, vocab_size=cfg.vocab_size, seed=0)
    return {route: tuple(_summary(*_zc_run(cfg, params, kb,
                                           pathlib.Path(tmp), route, share))
                         for share in (False, True))
            for route in ROUTES}


@pytest.fixture(scope="module")
def zc_runs(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zc")
    npz = tmp / "params.npz"
    np.savez(npz, params=np.array(jax.tree.map(np.asarray, world[4]),
                                  dtype=object))
    return run_pinned(__name__, tmp, "_zc_runs", str(npz), str(tmp))


@pytest.mark.parametrize("route", list(ROUTES))
def test_zerocopy_matches_copy_path_and_shares_blocks(zc_runs, route):
    cp, zc = zc_runs[route]
    for run in (cp, zc):
        assert run["completed"] == 4 and run["failed"] == 0
        assert all(s == State.DONE for s in run["states"])
        assert all(h > 0 for h in run["hits"])
    assert cp["outputs"] == zc["outputs"]
    assert cp["decode_steps"] == zc["decode_steps"]
    assert len(cp["trace"]) == len(zc["trace"]) > 0
    tol = KERNEL_TOL if route == "paged_kernel" else 0.0

    def same(a, b, msg):
        if tol:
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=msg)
        else:
            np.testing.assert_array_equal(a, b, err_msg=msg)

    for step, (tc, tz) in enumerate(zip(cp["trace"], zc["trace"])):
        assert set(tc) == set(tz), f"step {step}: membership differs"
        for rid in tc:
            same(tc[rid], tz[rid], f"step {step}, rid {rid}: logits differ")
    # every logical position's KV (layouts differ: the zero-copy table is
    # block-aligned per segment); decoded tokens' KV follows the decode
    assert set(cp["final_kv"]) == set(zc["final_kv"])
    for rid in cp["final_kv"]:
        (kc, vc, pc), (kz, vz, pz) = cp["final_kv"][rid], \
            zc["final_kv"][rid]
        np.testing.assert_array_equal(pc, pz)
        same(kc, kz, f"rid {rid}: final K")
        same(vc, vz, f"rid {rid}: final V")

    # sharing happened: shared blocks, zero-copy attaches, CoW fixups
    cz, cc = zc["counters"], cp["counters"]
    assert cz["shared_seg_hits"] > 0
    assert cz["shared_blocks_peak"] > 0
    assert zc["runs"] > 0
    assert cz["cow_clones"] > 0
    assert cc["shared_seg_hits"] == 0 and cc["shared_blocks_peak"] == 0
    # fewer blocks reserved at admission, a lower live-block peak
    assert cz["blocks_reserved_total"] < cc["blocks_reserved_total"]
    assert cz["live_blocks_peak"] < cc["live_blocks_peak"]
    assert cz["delta_blocks_saved"] > 0
    # every reader released: runs still pinned, tables drained
    assert zc["live_blocks"] == zc["run_blocks"]
    assert all(n == 0 for n in zc["readers"])


@pytest.fixture(scope="module")
def jax_zc(world, tmp_path_factory):
    """The :66 workload's zero-copy run through the JAX engine
    (``dense``)."""
    jcfg, jparams, kb = world[3], world[4], world[2]
    store = _store(tmp_path_factory.mktemp("jzc"), "j", JStore, JTiers)
    eng = j_build(JSpec(use_focus=False, store_fixed_variants=False,
                        force_recompute_fraction=0.3, pool_blocks=256,
                        attn_impl="dense",
                        sched=JSched(max_batch_tokens=100_000,
                                     max_decode_batch=8,
                                     max_prefill_batch=4),
                        share_chunk_kv=True, trace_decode=True),
                  cfg=jcfg, params=jparams, store=store)
    eng.run(_overlap_requests(kb, 4, request_cls=JRequest))
    eng.run(_overlap_requests(kb, 4, request_cls=JRequest))
    eng.clock = 0.0
    eng.stats = JStats()
    eng.counters.reset()
    eng.decode_trace = []
    eng.final_kv = {}
    reqs = _overlap_requests(kb, 4, request_cls=JRequest)
    stats = eng.run(reqs)
    return eng, stats, reqs


@pytest.mark.parametrize("route", list(ROUTES))
def test_zerocopy_run_matches_jax_engine(zc_runs, jax_zc, route):
    """Equal membership, plans, tokens and sharing counters; decode
    logits within 2e-4 of the JAX engine's zero-copy run."""
    zc = zc_runs[route][1]
    eng_j, stats_j, reqs_j = jax_zc
    assert zc["completed"] == stats_j.completed == 4
    assert zc["failed"] == stats_j.failed == 0
    assert zc["hits"] == [r.cache_hits for r in reqs_j]
    assert zc["computed"] == [r.prefill_tokens_computed for r in reqs_j]
    assert zc["outputs"] == [list(r.output_tokens) for r in reqs_j]
    cj = eng_j.counters
    for k in ("shared_seg_hits", "shared_blocks_peak", "cow_clones"):
        assert zc["counters"][k] == getattr(cj, k) > 0, k
    assert len(zc["trace"]) == len(eng_j.decode_trace) > 0
    for step, (tt, tj) in enumerate(zip(zc["trace"], eng_j.decode_trace)):
        assert set(tt) == set(tj), f"step {step}: membership differs"
        for rid in tj:
            np.testing.assert_allclose(tt[rid], np.asarray(tj[rid]),
                                       **JAX_TOL,
                                       err_msg=f"step {step}, rid {rid}")


# ---- pool and store only (:155, :198) --------------------------------------

def _fake_variant(store, cfg_dims, tokens, chash="c0"):
    L, hkv, dh = cfg_dims
    S = len(tokens)
    rng = np.random.default_rng(3)
    kv = {"k": rng.normal(size=(L, S, hkv, dh)).astype(np.float32),
          "v": rng.normal(size=(L, S, hkv, dh)).astype(np.float32)}
    scores = ChunkScores(chunk_index=0, length=S, a_bar=1.0, b_bar=0.0,
                         cci=0.1)
    return store.add_variant(chash, kv, scores)


def _pool_and_store(tmp_path, name):
    L, hkv, dh = 2, 2, 4
    pool = KVPool(num_layers=L, kv_heads=hkv, head_dim=dh, num_blocks=16,
                  block_size=4)
    store = ChunkStore(TieredStore(1 << 20, 1 << 20, str(tmp_path / name),
                                   start_worker=False),
                       n_chunks=1, m_variants=1)
    store.attach_pool(pool)
    var = _fake_variant(store, (L, hkv, dh), np.arange(6))

    def loader():
        kv, _ = store.get_kv(var)
        if kv is None:
            return None
        return (np.asarray(kv["k"], np.float32),
                np.asarray(kv["v"], np.float32),
                np.arange(kv["k"].shape[1], dtype=np.int32))

    return pool, store, var, loader


def test_evicting_variant_with_live_reader_defers_unpin(tmp_path):
    pool, store, var, loader = _pool_and_store(tmp_path, "evict")
    run = store.pin_pool_run(var, 0, loader)
    assert run is not None and run.readers == 1
    assert pool.live_blocks == len(run.blocks) == 2
    canonical = pool.k[:, run.blocks[0]].copy()
    assert store.tiers.pins.get(var.variant_id, 0) == 1

    store.remove(var)
    assert run.evict_pending
    assert pool.counters.run_unpins_deferred == 1
    assert pool.counters.run_unpins == 0
    assert pool.live_blocks == 2
    np.testing.assert_array_equal(pool.k[:, run.blocks[0]], canonical)

    store.release_pool_run(run)
    assert pool.counters.run_unpins == 1
    assert pool.live_blocks == 0
    assert pool.free_blocks == pool.num_blocks
    assert store.residency.runs == {}


def test_evicting_variant_without_readers_unpins_immediately(tmp_path):
    pool, store, var, loader = _pool_and_store(tmp_path, "evict0")
    run = store.pin_pool_run(var, 0, loader)
    store.release_pool_run(run)
    assert pool.live_blocks == 2
    store.remove(var)
    assert pool.counters.run_unpins == 1
    assert pool.counters.run_unpins_deferred == 0
    assert pool.free_blocks == pool.num_blocks


# ---- engine level (:225, :261, :303, :338) ---------------------------------

def _share_engine(world, route, store, pool_blocks, frac, prefill_batch,
                  share=True):
    cfg, tparams = world[:2]
    return build_engine(
        EngineSpec(use_focus=False, store_fixed_variants=False,
                   force_recompute_fraction=frac, pool_blocks=pool_blocks,
                   sched=SchedulerConfig(max_batch_tokens=100_000,
                                         max_decode_batch=8,
                                         max_prefill_batch=prefill_batch),
                   share_chunk_kv=share, device="cpu", **ROUTES[route]),
        cfg=cfg, params=tparams, store=store)


@pytest.mark.parametrize("route", list(ROUTES))
def test_delta_reservation_admits_what_full_reservation_defers(
        world, tmp_path, route):
    """4 overlapping requests cannot all reserve their full need, but the
    shared-run delta fits: zero-copy packs all 4 into one pass, the copy
    engine defers."""
    kb = world[2]
    packed_max, fails = {}, {}
    for share in (False, True):
        eng = _share_engine(world, route, _store(tmp_path, f"d{share}"),
                            22, 0.0, 4, share=share)
        eng.run(_overlap_requests(kb, 2))
        eng.run(_overlap_requests(kb, 2))
        eng.clock = 0.0
        eng.stats = EngineStats()
        eng.counters.reset()
        reqs = _overlap_requests(kb, 4)
        stats = eng.run(reqs)
        assert stats.completed == 4 and stats.failed == 0
        packed_max[share] = stats.prefill_batch_max
        fails[share] = eng.counters.reserve_failures
    assert packed_max[True] == 4
    assert packed_max[False] < 4
    assert fails[True] == 0
    assert fails[False] > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_unbudgeted_cow_pressure_escalates_not_fails(world, tmp_path,
                                                     route):
    """The delta estimate does not budget CoW clones: a failed zero-copy
    write-back escalates to a full reservation and completes."""
    kb = world[2]
    eng = _share_engine(world, route, _store(tmp_path, "cow"), 22, 0.3, 4)
    eng.run(_overlap_requests(kb, 2))
    eng.run(_overlap_requests(kb, 2))
    eng.stats = EngineStats()
    eng.counters.reset()
    reqs = _overlap_requests(kb, 4)
    stats = eng.run(reqs)
    assert stats.completed == 4 and stats.failed == 0
    assert all(r.state == State.DONE for r in reqs)
    assert eng.counters.burn_requeues <= 4


def _requests_for(kb, chunk_ids, n, seed, max_new=3):
    rng = np.random.default_rng(seed)
    sys_t = np.random.default_rng(17).integers(
        0, kb.vocab_size, 8).astype(np.int32)
    chunks = [kb.chunks[i] for i in chunk_ids]
    return [Request(rid=seed * 100 + i, system_tokens=sys_t,
                    chunk_tokens=[c.copy() for c in chunks],
                    question_tokens=rng.integers(
                        0, kb.vocab_size, 10).astype(np.int32),
                    max_new_tokens=max_new, arrival_time=0.0)
            for i in range(n)]


@pytest.mark.parametrize("route", list(ROUTES))
def test_cold_runs_reclaimed_under_admission_pressure(world, tmp_path,
                                                      route):
    """Zero-reader canonical runs give their blocks back when a new
    working set cannot reserve."""
    kb = world[2]
    store = _store(tmp_path, "reclaim")
    eng = _share_engine(world, route, store, 24, 0.0, 2)
    for chunk_ids, seed in (((0, 1, 2), 1), ((3, 4, 5), 2)):
        eng.run(_requests_for(kb, chunk_ids, 2, seed))
        eng.run(_requests_for(kb, chunk_ids, 2, seed))
    assert sum(len(r.blocks) for r in store.residency.runs.values()) > 0
    reqs = _requests_for(kb, (6, 7), 3, 3)
    assert eng.pool.free_blocks < 3 * eng.pool.blocks_needed(
        sum(len(t) for t in [reqs[0].system_tokens,
                             *reqs[0].chunk_tokens,
                             reqs[0].question_tokens]))
    failed_before = eng.stats.failed
    eng.run(reqs)
    assert all(r.state == State.DONE for r in reqs)
    assert eng.stats.failed == failed_before
    assert eng.counters.run_reclaims > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_sequential_engines_reuse_one_store(world, tmp_path, route):
    """A second share-enabled engine over the same store drains the first
    pool's zero-reader runs and re-attaches, leaking no tier pins."""
    kb = world[2]
    store = _store(tmp_path, "seq")
    eng1 = _share_engine(world, route, store, 128, 0.0, 2)
    eng1.run(_overlap_requests(kb, 2))
    eng1.run(_overlap_requests(kb, 2))
    assert store.residency.runs
    assert dict(store.tiers.pins)

    eng2 = _share_engine(world, route, store, 128, 0.0, 2)
    assert store.residency.pool is eng2.pool
    assert store.residency.runs == {}
    assert store.tiers.pins == {}
    reqs = _overlap_requests(kb, 2)
    eng2.run(reqs)
    assert all(r.state == State.DONE for r in reqs)

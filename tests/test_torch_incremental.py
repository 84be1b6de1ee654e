"""The incremental decode batch inside the port: joins and leaves handled
in place against the always-rebuild path (the reference's
``tests/test_engine_incremental.py`` :64 and :216), and paged decode
against the arena under churn and with shared chunks
(``tests/test_paged_decode.py`` :91 and :124).

Tiny llama3-8b with the reference's weights (``params_from_jax``), on
the three routes the engine serves: ``default`` (``attn_impl=None``),
``kernel`` and ``paged_kernel`` with ``paged_decode=True`` (their
kernels' ``ref.py`` on the CPU). Incremental == rebuild is byte-equal
on every route: both modes launch the same (B, S) batch, or on the
paged route the same block rows, so only the row map differs.
Paged == arena compares two decode routes, ``paged`` against the
default arena, byte for byte as the reference does.

The runs these gates compare are made in a fresh interpreter with the
host BLAS pinned to its reproducible mode (``run_pinned``,
``MKL_CBWR=COMPATIBLE``; ROADMAP C9): without the pin the host's first
fp32 products in a process are now and then ~1e-4 off.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro_torch.configs import get_tiny
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate
from test_torch_preempt import run_pinned

torch.set_num_threads(2)

ROUTES = {
    "default": dict(attn_impl=None),
    "kernel": dict(attn_impl="kernel"),
    "paged_kernel": dict(attn_impl="paged_kernel", paged_decode=True),
}


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jparams = JM.init_params(j_tiny("llama3-8b"), jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    kb = KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0)
    return cfg, tparams, kb


def _churny_requests(kb, lengths=(3, 5, 7, 9, 4, 6), seed=11):
    """All-at-once arrivals with varied decode lengths: with one
    admission per iteration the decode batch sees a join or a leave on
    most steps."""
    reqs = generate(kb, WorkloadConfig(num_requests=len(lengths), qpm=1e9,
                                       seed=seed, k_chunks=3,
                                       max_new_tokens=4))
    for r, n in zip(reqs, lengths):
        r.max_new_tokens = n
    return reqs


def _run_incremental(world, route, incremental):
    cfg, tparams, kb = world
    eng = build_engine(
        EngineSpec(strategy="all", use_focus=False, pool_blocks=512,
                   decode_bucket_b=4, seq_bucket=320,
                   sched=SchedulerConfig(max_batch_tokens=100_000,
                                         max_decode_batch=4,
                                         max_prefill_batch=1),
                   incremental_decode=incremental, trace_decode=True,
                   device="cpu", **ROUTES[route]),
        cfg=cfg, params=tparams, store=None)
    reqs = _churny_requests(kb)
    stats = eng.run(reqs)
    return eng, stats, reqs


def _summary(eng, stats, reqs):
    c, pool = eng.counters, eng.pool
    return dict(
        completed=stats.completed, failed=stats.failed,
        decode_steps=stats.decode_steps,
        states=[r.state for r in reqs],
        outputs=[list(r.output_tokens) for r in reqs],
        trace=eng.decode_trace, final_kv=eng.final_kv,
        counters={k: getattr(c, k) for k in (
            "decode_rebuilds", "decode_joins", "decode_leaves",
            "decode_rows_recycled", "decode_gather_bytes",
            "decode_join_copies", "paged_block_syncs", "paged_sync_bytes",
            "cow_clones")},
        pool=dict(reserved=pool.reserved_blocks, live=pool.live_blocks,
                  free=pool.free_blocks, blocks=pool.num_blocks))


def _compared_runs(npz):
    """Every run the byte-equality gates below compare: incremental and
    rebuild on each route, arena and paged under churn, with and without
    a store."""
    cfg = get_tiny("llama3-8b")
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    world = (cfg, TM.params_from_jax(cfg, leaves, "cpu"),
             KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0))
    out = {(route, inc): _summary(*_run_incremental(world, route, inc))
           for route in ROUTES for inc in (True, False)}
    for store in (False, True):
        for paged in (False, True):
            out[("paged", store, paged)] = _summary(*_run_paged(
                world, paged=paged, store=store,
                strategy="cachecraft" if store else "all"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("incremental")
    npz = tmp / "params.npz"
    jparams = JM.init_params(j_tiny("llama3-8b"), jax.random.PRNGKey(0))
    np.savez(npz, params=np.array(jax.tree.map(np.asarray, jparams),
                                  dtype=object))
    return run_pinned(__name__, tmp, "_compared_runs", str(npz))


def _assert_bit_identical(a, b):
    """Per-step decode membership and logits, and final pool KV, bit for
    bit."""
    assert len(a["trace"]) == len(b["trace"]) > 0
    for step, (ta, tb) in enumerate(zip(a["trace"], b["trace"])):
        assert set(ta) == set(tb), f"step {step}: membership differs"
        for rid in ta:
            np.testing.assert_array_equal(
                ta[rid], tb[rid],
                err_msg=f"step {step}, rid {rid}: decode logits differ")
    assert set(a["final_kv"]) == set(b["final_kv"])
    for rid in a["final_kv"]:
        ka, va, pa = a["final_kv"][rid]
        kb, vb, pb = b["final_kv"][rid]
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("route", list(ROUTES))
def test_incremental_matches_rebuild(runs, route):
    i, r = runs[(route, True)], runs[(route, False)]
    assert i["completed"] == 6 and i["failed"] == 0
    assert r["completed"] == 6 and r["failed"] == 0

    # churn handled in place: one rebuild creates the batch, the rebuild
    # engine regathers on every join or leave
    ci, cr = i["counters"], r["counters"]
    assert ci["decode_rebuilds"] == 1
    assert cr["decode_rebuilds"] > ci["decode_rebuilds"]
    assert ci["decode_joins"] >= 4
    assert ci["decode_leaves"] >= 5
    assert ci["decode_rows_recycled"] >= 1
    assert cr["decode_joins"] == 0 and cr["decode_leaves"] == 0

    assert i["decode_steps"] == r["decode_steps"]
    _assert_bit_identical(i, r)
    assert all(s == State.DONE for s in i["states"])
    assert i["outputs"] == r["outputs"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_batch_shape_growth_triggers_rebuild(world, route):
    """A joiner that does not fit the row arena (S too small) falls back
    to a full rebuild rather than truncating its KV."""
    cfg, tparams, kb = world
    eng = build_engine(
        EngineSpec(strategy="all", use_focus=False, pool_blocks=512,
                   decode_bucket_b=4, seq_bucket=32,
                   sched=SchedulerConfig(max_batch_tokens=100_000,
                                         max_decode_batch=4,
                                         max_prefill_batch=1),
                   device="cpu", **ROUTES[route]),
        cfg=cfg, params=tparams, store=None)
    reqs = generate(kb, WorkloadConfig(num_requests=3, qpm=1e9, seed=6,
                                       k_chunks=2, max_new_tokens=3))
    reqs[1].question_tokens = np.concatenate(
        [reqs[1].question_tokens,
         np.zeros(64, reqs[1].question_tokens.dtype)])
    stats = eng.run(reqs)
    assert stats.completed == 3 and stats.failed == 0
    assert eng.counters.decode_rebuilds >= 2
    for r in reqs:
        assert len(r.output_tokens) == r.max_new_tokens


# ---- paged == arena under churn (tests/test_paged_decode.py :91, :124) ------

def _run_paged(world, *, paged, strategy="all", store=False):
    cfg, tparams, kb = world
    spec = EngineSpec(
        strategy=strategy, use_focus=False, pool_blocks=512,
        decode_bucket_b=4, seq_bucket=512,
        sched=SchedulerConfig(max_batch_tokens=100_000,
                              max_decode_batch=4, max_prefill_batch=2),
        trace_decode=True, paged_decode=paged, device="cpu")
    kw = {} if store else {"store": None}
    eng = build_engine(spec, cfg=cfg, params=tparams, **kw)
    reqs = _churny_requests(kb)
    stats = eng.run(reqs)
    if eng.store is not None:
        eng.store.tiers.close()
    return eng, stats, reqs


def test_paged_matches_arena_churny(runs):
    a, p = runs[("paged", False, False)], runs[("paged", False, True)]
    assert a["completed"] == 6 and a["failed"] == 0
    assert p["completed"] == 6 and p["failed"] == 0
    assert all(s == State.DONE for s in a["states"] + p["states"])
    assert a["outputs"] == p["outputs"]
    _assert_bit_identical(a, p)
    # the arena copies KV on every rebuild / join; the paged path moves no
    # gather bytes, only dirty-block syncs of fresh pool blocks
    ca, cp = a["counters"], p["counters"]
    assert ca["decode_gather_bytes"] > 0
    assert ca["decode_join_copies"] > 0
    assert cp["decode_gather_bytes"] == 0
    assert cp["decode_join_copies"] == 0
    assert cp["paged_block_syncs"] > 0
    assert cp["paged_sync_bytes"] < ca["decode_gather_bytes"]
    assert cp["decode_joins"] >= 4
    assert cp["decode_leaves"] >= 5
    assert p["pool"] == dict(reserved=0, live=0, free=512, blocks=512)


def test_paged_matches_arena_shared_chunks(runs):
    """With a chunk store and zero-copy sharing the paged path reads
    shared blocks in place and CoW-clones on writes; still byte-equal to
    the arena run."""
    a, p = runs[("paged", True, False)], runs[("paged", True, True)]
    assert a["completed"] == 6 and a["failed"] == 0
    assert p["completed"] == 6 and p["failed"] == 0
    _assert_bit_identical(a, p)
    assert p["counters"]["cow_clones"] > 0
    assert p["counters"]["decode_gather_bytes"] == 0

"""The engine under pool pressure, inside the port: reservation-aware
preemption, the shortage valve, the deadline guard and the scheduler's
victim policies (the reference's ``tests/test_preemption.py`` and
``tests/test_engine_incremental.py`` :110 / :171, re-proved on the
port), and the pressured workload held against the JAX engine.

Tiny llama3-8b with the reference's weights (``params_from_jax``). The
engine-level gates run on the three routes the engine serves:
``default`` (``attn_impl=None``: dense prefill windows, ``auto``
decode), ``kernel`` (chunk and decode kernels; their ``ref.py`` on the
CPU) and ``paged_kernel`` with ``paged_decode=True``. Where the
reference is byte-equal, the default route is byte-equal; the kernel
routes are held to ``KERNEL_TOL`` (2e-4, ROADMAP C3): their prefill
windows sum over the packed S, which follows the packing partner, and
pool pressure changes the partner.

The runs these gates compare byte for byte or at a tolerance are made
in a fresh interpreter with the host BLAS pinned to its reproducible
mode (``run_pinned``, ``MKL_CBWR=COMPATIBLE``; ROADMAP C9): without the pin
the host's first fp32 products in a process are now and then ~1e-4 off.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_tiny
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.tiers import TieredStore
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.kvpool import BlockTable, KVPool, Reservation
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = {
    "default": dict(attn_impl=None),
    "kernel": dict(attn_impl="kernel"),
    "paged_kernel": dict(attn_impl="paged_kernel", paged_decode=True),
}
# the kernel routes' prefill sums follow the packed S (ROADMAP C3)
KERNEL_TOL = 2e-4
# port vs the JAX engine: the port's model parity standard
JAX_TOL = dict(rtol=2e-4, atol=2e-4)


def _assert_close(a, b, route, msg):
    if route == "default":
        np.testing.assert_array_equal(a, b, err_msg=msg)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=KERNEL_TOL,
                                   err_msg=msg)


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 "cpu")
    kb = KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0)
    return cfg, tparams, kb, jcfg, jparams


def _store(tmp_path, name="s"):
    return ChunkStore(TieredStore(1 << 28, 1 << 28, str(tmp_path / name),
                                  start_worker=False), 50, 4)


def _spec(route, **kw):
    return EngineSpec(device="cpu", **ROUTES[route], **kw)


def _starved_requests(kb, n_long=2, n_short=3, long_new=20, short_new=4):
    """Long decodes fill the pool first; shorts stall behind them."""
    reqs = generate(kb, WorkloadConfig(num_requests=n_long + n_short,
                                       qpm=1e9, seed=13, k_chunks=3,
                                       max_new_tokens=short_new))
    for r in reqs[:n_long]:
        r.max_new_tokens = long_new
    return reqs


def _engine(world, route, pool_blocks, preempt_after, store=None, **kw):
    cfg, tparams = world[0], world[1]
    return build_engine(
        _spec(route, strategy="all", use_focus=False,
              pool_blocks=pool_blocks, decode_bucket_b=4, seq_bucket=512,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=2,
                                    preempt_after_iters=preempt_after),
              **kw),
        cfg=cfg, params=tparams, store=store)


def _preempt_churn_requests(kb):
    """Two long decodes hog the pool, four short requests churn the
    decode batch behind them (the reference's workload, seed 17)."""
    reqs = generate(kb, WorkloadConfig(num_requests=6, qpm=1e9, seed=17,
                                       k_chunks=3, max_new_tokens=4))
    for r, n in zip(reqs, (18, 18, 3, 5, 4, 6)):
        r.max_new_tokens = n
    return reqs


def _run_preempt(world, route, pool_blocks, preempt_after, **kw):
    eng = _engine(world, route, pool_blocks, preempt_after,
                  trace_decode=True, **kw)
    reqs = _preempt_churn_requests(world[2])
    stats = eng.run(reqs)
    last = {}
    for step_logits in eng.decode_trace:
        last.update(step_logits)
    return eng, stats, reqs, last


def _summary(eng, stats, reqs, last):
    c, pool = eng.counters, eng.pool
    return dict(
        completed=stats.completed, failed=stats.failed,
        prefill_tokens_computed=stats.prefill_tokens_computed,
        states=[r.state for r in reqs],
        outputs=[list(r.output_tokens) for r in reqs],
        hits=[r.cache_hits for r in reqs],
        computed=[r.prefill_tokens_computed for r in reqs],
        trace=eng.decode_trace, final_kv=eng.final_kv, last=last,
        counters={k: getattr(c, k) for k in (
            "preemptions", "preempt_block_recovered", "head_stall_iters_max",
            "decode_leaves", "burn_requeues", "decode_gather_bytes",
            "reservations_made", "reservations_committed",
            "reservations_cancelled")},
        pool=dict(reserved=pool.reserved_blocks, live=pool.live_blocks,
                  free=pool.free_blocks, blocks=pool.num_blocks))


def _churn_runs(npz):
    """Every route's unpressured (pool 512) and pressured (pool 20,
    ``preempt_after_iters`` 4) run of the churn workload, and the default
    route's pressured run with ``paged_decode`` (``"paged"``)."""
    cfg = get_tiny("llama3-8b")
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    world = (cfg, TM.params_from_jax(cfg, leaves, "cpu"),
             KnowledgeBase(num_chunks=10, vocab_size=cfg.vocab_size, seed=0))
    out = {(route, pool): _summary(*_run_preempt(world, route, pool,
                                                 4 if pool == 20 else 0))
           for route in ROUTES for pool in (512, 20)}
    out[("paged", 20)] = _summary(*_run_preempt(world, "default", 20, 4,
                                                paged_decode=True))
    return out


def start_pinned(module, tmp_path, fn, *args, pin=True, threads=2):
    """Start ``fn(*args)`` of test module ``module`` in a fresh
    interpreter whose host BLAS is pinned to its reproducible mode
    (``MKL_CBWR=COMPATIBLE``, ROADMAP C9) on ``threads`` threads;
    ``finish_pinned`` waits for it and returns its result. ``pin=False``
    leaves the host BLAS in its default mode (on one thread C9's flake is
    gone there too)."""
    out = tmp_path / f"{fn}-{pin}-{threads}.pkl"
    code = ("import pickle, sys, torch; sys.path[:0] = ['src', 'tests']; "
            f"torch.set_num_threads({threads}); import {module} as T; "
            f"pickle.dump(T.{fn}(*{args!r}), open({str(out)!r}, 'wb'))")
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    env.pop("MKL_CBWR", None)
    if pin:
        env["MKL_CBWR"] = "COMPATIBLE"
    # the child's output to a file: a pipe that nothing reads while the
    # caller works would stall a child that writes much
    err = open(out.with_suffix(".err"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=err, stderr=subprocess.STDOUT)
    return proc, out, err


def finish_pinned(started):
    proc, out, err = started
    try:
        proc.wait(timeout=900)
        err.seek(0)
        assert proc.returncode == 0, err.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
        err.close()
    with open(out, "rb") as f:
        return pickle.load(f)


def run_pinned(module, tmp_path, fn, *args, pin=True, threads=2):
    """``fn(*args)`` as ``start_pinned`` runs it, waited for; the result
    comes back pickled. The comparing runs of the pressure gates go
    through here."""
    return finish_pinned(start_pinned(module, tmp_path, fn, *args, pin=pin,
                                      threads=threads))


@pytest.fixture(scope="module")
def churn_runs(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("churn")
    npz = tmp / "params.npz"
    np.savez(npz, params=np.array(jax.tree.map(np.asarray, world[4]),
                                  dtype=object))
    return run_pinned(__name__, tmp, "_churn_runs", str(npz))


def _assert_settled(eng):
    c = eng.counters
    assert c.reservations_made == c.reservations_committed \
        + c.reservations_cancelled
    assert eng.pool.reserved_blocks == 0 and eng.pool.live_blocks == 0
    assert eng.pool.free_blocks == eng.pool.num_blocks


# ---- tests/test_engine_incremental.py:171 and :110 -------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_preempted_requests_match_unpressured(churn_runs, route):
    """A preempted request re-prefills from scratch and re-decodes: its
    outputs, final decode logits and final pool KV equal an unpressured
    run's (byte for byte on the default route)."""
    u, p = churn_runs[(route, 512)], churn_runs[(route, 20)]
    assert u["counters"]["preemptions"] == 0
    assert p["counters"]["preemptions"] > 0
    assert u["failed"] == 0 and p["failed"] == 0
    assert u["completed"] == 6 and p["completed"] == 6
    assert all(s == State.DONE for s in p["states"])
    assert u["outputs"] == p["outputs"], "outputs diverged under preemption"
    assert set(u["last"]) == set(p["last"])
    for rid in u["last"]:
        _assert_close(p["last"][rid], u["last"][rid], route,
                      f"{route} rid {rid}: final decode logits differ")
    assert set(u["final_kv"]) == set(p["final_kv"])
    for rid in u["final_kv"]:
        ku, vu, pu = u["final_kv"][rid]
        kp, vp, pp = p["final_kv"][rid]
        np.testing.assert_array_equal(pu, pp)
        _assert_close(kp, ku, route, f"{route} rid {rid}: final K")
        _assert_close(vp, vu, route, f"{route} rid {rid}: final V")
    c = p["counters"]
    assert c["decode_leaves"] > 0
    assert c["burn_requeues"] == 0
    assert c["reservations_made"] == c["reservations_committed"] \
        + c["reservations_cancelled"]
    assert p["pool"] == dict(reserved=0, live=0, free=20, blocks=20)


@pytest.mark.parametrize("route", list(ROUTES))
def test_zero_burn_requeues_under_pool_pressure(world, route):
    """Reserve-at-admission: with a pool of ~1.5 requests every admission
    already owns its blocks, so nothing burns a packed pass."""
    cfg, tparams, kb = world[:3]
    eng = build_engine(
        _spec(route, strategy="all", use_focus=False, pool_blocks=12,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=8,
                                    max_prefill_batch=4)),
        cfg=cfg, params=tparams, store=None)
    reqs = generate(kb, WorkloadConfig(num_requests=4, qpm=1e9, seed=3,
                                       k_chunks=3, max_new_tokens=3))
    stats = eng.run(reqs)
    c = eng.counters
    assert c.burn_requeues == 0
    assert c.reserve_failures > 0
    assert stats.completed == 4 and stats.failed == 0
    assert all(r.state == State.DONE for r in reqs)
    _assert_settled(eng)


# ---- tests/test_preemption.py, engine level --------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_preemption_bounds_head_stall_and_settles_pool(world, route):
    eng = _engine(world, route, pool_blocks=20, preempt_after=4)
    reqs = _starved_requests(world[2])
    stats = eng.run(reqs)
    c = eng.counters
    assert c.preemptions > 0
    assert c.preempt_block_recovered > 0
    assert stats.failed == 0 and stats.completed == len(reqs)
    assert all(r.state == State.DONE for r in reqs)
    assert all(len(r.output_tokens) == r.max_new_tokens for r in reqs)
    # a preemption fires at stall == preempt_after_iters; slack for the
    # iteration in which the retried admission lands
    assert c.head_stall_iters_max <= 4 + 2
    assert c.burn_requeues == 0
    _assert_settled(eng)
    assert eng.scheduler.retries == {} and eng.scheduler.preemptions == {}


@pytest.mark.parametrize("route", list(ROUTES))
def test_deferral_only_lets_head_stall_run_long(world, route):
    """Control for the bound above: no preemption, a full-drain stall."""
    eng = _engine(world, route, pool_blocks=20, preempt_after=0)
    reqs = _starved_requests(world[2])
    stats = eng.run(reqs)
    assert eng.counters.preemptions == 0
    assert stats.failed == 0 and stats.completed == len(reqs)
    assert eng.counters.head_stall_iters_max > 4 + 2


@pytest.mark.parametrize("route", list(ROUTES))
def test_preempted_request_reuses_shared_runs(world, tmp_path, route):
    """Zero-copy engines: a preempted request's shared runs stay resident
    at zero readers, so its re-entry re-attaches them."""
    cfg, tparams, kb = world[:3]
    store = _store(tmp_path)
    eng = build_engine(
        _spec(route, strategy="cachecraft", use_focus=False,
              force_recompute_fraction=0.25, store_fixed_variants=False,
              pool_blocks=26, decode_bucket_b=4, seq_bucket=512,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=2,
                                    preempt_after_iters=4)),
        cfg=cfg, params=tparams, store=store)
    eng.run(_starved_requests(kb, n_long=0, n_short=3))
    reqs = _starved_requests(kb)
    stats = eng.run(reqs)
    c = eng.counters
    assert stats.failed == 0
    assert all(r.state == State.DONE for r in reqs)
    assert c.preemptions > 0
    assert c.shared_seg_hits > 0
    assert eng.pool.reserved_blocks == 0
    assert c.reservations_made == c.reservations_committed \
        + c.reservations_cancelled


@pytest.mark.parametrize("route", list(ROUTES))
def test_multi_victim_preemption_accumulates_for_large_head(world, route):
    """A head larger than any one victim's holdings is served by
    preempting victims newest-first within one stall event."""
    cfg, tparams = world[:2]
    rng = np.random.default_rng(0)

    def mk(rid, sys_len, q_len, new):
        return Request(rid=rid,
                       system_tokens=rng.integers(
                           0, cfg.vocab_size, sys_len).astype(np.int32),
                       chunk_tokens=[],
                       question_tokens=rng.integers(
                           0, cfg.vocab_size, q_len).astype(np.int32),
                       max_new_tokens=new, arrival_time=0.0)

    # smalls need 4 blocks each, the big one 9 = the whole pool
    reqs = [mk(0, 32, 16, 8), mk(1, 32, 16, 8), mk(2, 96, 32, 4)]
    eng = _engine(world, route, pool_blocks=9, preempt_after=4)
    stats = eng.run(reqs)
    assert stats.failed == 0 and stats.completed == 3
    assert all(r.state == State.DONE for r in reqs)
    assert all(len(r.output_tokens) == r.max_new_tokens for r in reqs)
    assert eng.counters.preemptions == 2
    assert eng.pool.free_blocks == eng.pool.num_blocks


@pytest.mark.parametrize("route", list(ROUTES))
def test_reclaimable_shortage_never_fails_requests(world, tmp_path, route):
    """The shortage valve burns a retry only when shortage is terminal,
    never while cold-run reclaim can still recover blocks."""
    cfg, tparams, kb = world[:3]
    store = _store(tmp_path)
    eng = build_engine(
        _spec(route, strategy="cachecraft", use_focus=False,
              force_recompute_fraction=0.25, store_fixed_variants=False,
              pool_blocks=28,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=2,
                                    preempt_after_iters=4)),
        cfg=cfg, params=tparams, store=store)
    reqs = generate(kb, WorkloadConfig(num_requests=8, qpm=1e9, seed=11,
                                       max_new_tokens=6))
    for r in reqs[:2]:
        r.max_new_tokens = 20
    stats = eng.run(reqs)
    assert stats.failed == 0
    assert all(r.state == State.DONE for r in reqs)
    assert all(len(r.output_tokens) == r.max_new_tokens for r in reqs)
    assert eng.counters.preemptions > 0
    runs = store.residency.runs.values()
    run_blocks = sum(len(r.blocks) for r in runs)
    assert all(r.readers == 0 for r in runs)
    assert eng.pool.reserved_blocks == 0
    assert eng.pool.live_blocks == run_blocks
    assert eng.pool.free_blocks + run_blocks == eng.pool.num_blocks


@pytest.mark.parametrize("route", list(ROUTES))
def test_terminal_shortage_still_converges_to_failed(world, route):
    """Unrecoverable shortage (a leaked reservation, nothing decoding,
    nothing reclaimable) burns bounded retries and FAILs the head."""
    cfg, tparams, kb = world[:3]
    eng = build_engine(
        _spec(route, strategy="all", use_focus=False, pool_blocks=16,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=1, retry_limit=1)),
        cfg=cfg, params=tparams, store=None)
    assert eng.pool.reserve(10) is not None    # leaked, never closed
    reqs = generate(kb, WorkloadConfig(num_requests=1, qpm=1e9, seed=3,
                                       max_new_tokens=4))
    stats = eng.run(reqs, max_iters=50)
    assert reqs[0].state == State.FAILED
    assert stats.failed == 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_deadline_expires_starved_queued_request(world, route):
    """``deadline_s`` fires from ``Engine.step``: the starved second
    request FAILs through the teardown with clean pool accounting."""
    cfg, tparams, kb = world[:3]
    eng = build_engine(
        _spec(route, strategy="all", use_focus=False, pool_blocks=14,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=4, deadline_s=1e-6)),
        cfg=cfg, params=tparams, store=None)
    reqs = generate(kb, WorkloadConfig(num_requests=2, qpm=1e9, seed=3,
                                       max_new_tokens=4))
    for r in reqs:
        r.arrival_time = 0.0
    stats = eng.run(reqs)
    assert reqs[0].state == State.DONE
    assert reqs[1].state == State.FAILED
    assert stats.completed == 1 and stats.failed == 1
    assert eng.counters.deadline_expired == 1
    assert eng.pool.reserved_blocks == 0 and eng.pool.live_blocks == 0
    assert eng.pool.free_blocks == eng.pool.num_blocks
    assert eng.scheduler.retries == {}


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_deadline_means_no_expiry(world, route):
    cfg, tparams, kb = world[:3]
    eng = build_engine(
        _spec(route, strategy="all", use_focus=False, pool_blocks=512,
              sched=SchedulerConfig(max_batch_tokens=100_000,
                                    max_decode_batch=4,
                                    max_prefill_batch=1)),
        cfg=cfg, params=tparams, store=None)
    reqs = generate(kb, WorkloadConfig(num_requests=2, qpm=1e9, seed=3,
                                       max_new_tokens=4))
    stats = eng.run(reqs)
    assert stats.completed == 2 and stats.failed == 0
    assert eng.counters.deadline_expired == 0


def test_requeue_resets_stale_attempt_metrics(world):
    """``Engine._requeue`` clears every per-attempt field and keeps the
    arrival identity."""
    cfg, tparams = world[:2]
    eng = build_engine(
        _spec("default", strategy="all", use_focus=False, pool_blocks=64),
        cfg=cfg, params=tparams, store=None)
    req = _req(1)
    eng.scheduler.enqueue(req, clock=1.5)
    eng.scheduler.queue.popleft()
    req.reservation = eng.pool.reserve(2)
    req.output_tokens = [7, 8]
    req.total_len = 30
    req.t_first_service = 2.0
    req.t_prefill_start = 2.0
    req.t_first_token = 3.0
    req.prefill_tokens_total = 30
    req.prefill_tokens_computed = 20
    req.cache_hits = 2
    req.load_seconds_modeled = 0.5
    req.delta_blocks_saved = 1
    eng._requeue(req)
    assert req.state == State.QUEUED
    assert req.output_tokens == [] and req.total_len == 0
    assert req.t_prefill_start is None and req.t_first_token is None
    assert req.prefill_tokens_total == 0
    assert req.prefill_tokens_computed == 0
    assert req.cache_hits == 0 and req.load_seconds_modeled == 0.0
    assert req.delta_blocks_saved == 0
    assert req.reservation is None
    assert req.t_enqueued == 1.5
    assert req.t_first_service == 2.0
    assert req.queue_wait == 0.5
    assert eng.pool.reserved_blocks == 0
    assert eng.pool.free_blocks == eng.pool.num_blocks


# ---- pool teardown with shared refs in flight (test_preemption.py:384) -----

def test_reclaim_request_conserves_with_shared_refs_in_flight():
    pool = KVPool(num_layers=2, kv_heads=2, head_dim=4, num_blocks=12,
                  block_size=4)
    run_blocks = pool.alloc(2)
    k_run = np.arange(2 * 8 * 2 * 4, dtype=np.float32).reshape(2, 8, 2, 4)
    pool.write_run(run_blocks, k_run, k_run + 0.5,
                   np.arange(8, dtype=np.int32))
    run_bytes = pool.k[:, run_blocks].copy()
    table = BlockTable()
    res = pool.reserve(3)
    assert pool.append_shared(table, run_blocks) == 0
    tok = np.ones((2, 2, 4), np.float32)
    assert pool.append_token(table, tok, tok, 8, reservation=res)
    assert res.drawn >= 1 and res.remaining <= 2
    assert pool.free_blocks + pool.live_blocks + pool.reserved_blocks \
        == pool.num_blocks
    before_free = pool.free_blocks

    freed = pool.reclaim_request(table, res)
    assert freed == pool.free_blocks - before_free
    assert pool.free_blocks + pool.live_blocks + pool.reserved_blocks \
        == pool.num_blocks
    assert pool.reserved_blocks == 0 and res.closed
    assert table.blocks == [] and table.length == 0
    assert all(pool.refs[b] == 1 for b in run_blocks)
    np.testing.assert_array_equal(pool.k[:, run_blocks], run_bytes)
    pool.release(run_blocks)
    assert pool.free_blocks == pool.num_blocks
    assert pool.live_blocks == 0


# ---- the port's scheduler (test_preemption.py:197-315, :482) ---------------

def _req(rid, need=16, max_new=4):
    return Request(rid=rid, system_tokens=np.zeros(need, np.int32),
                   chunk_tokens=[], question_tokens=np.zeros(1, np.int32),
                   max_new_tokens=max_new)


def test_scheduler_stall_tracking_and_policy():
    sched = Scheduler(SchedulerConfig(preempt_after_iters=3))
    assert not sched.should_preempt()
    assert sched.note_head_stall(1) == 1
    assert sched.note_head_stall(1) == 2
    assert not sched.should_preempt()
    assert sched.note_head_stall(2) == 1
    assert sched.note_head_stall(2) == 2
    assert sched.note_head_stall(2) == 3
    assert sched.should_preempt()
    sched.note_head_progress()
    assert not sched.should_preempt()
    off = Scheduler(SchedulerConfig(preempt_after_iters=0))
    for _ in range(10):
        off.note_head_stall(1)
    assert not off.should_preempt()


def test_scheduler_victim_selection_newest_first_with_limit():
    sched = Scheduler(SchedulerConfig(preempt_after_iters=1,
                                      preempt_limit=2))
    a, b, c = _req(1), _req(2), _req(3)
    decoding = [a, b, c]
    assert sched.select_victim(decoding) is c
    sched.preemptions[c.rid] = 2
    assert sched.select_victim(decoding) is b
    sched.preemptions[b.rid] = 2
    assert sched.select_victim(decoding) is a
    sched.preemptions[a.rid] = 2
    assert sched.select_victim(decoding) is None
    assert sched.select_victim([]) is None


def test_scheduler_victim_selection_fewest_blocks_policy():
    sched = Scheduler(SchedulerConfig(preempt_after_iters=1,
                                      preempt_limit=2,
                                      victim_policy="fewest-blocks"))
    a, b, c = _req(1), _req(2), _req(3)
    a.table.blocks = [0, 1, 2, 3]
    b.table.blocks = [4]
    c.table.blocks = [5, 6, 7]
    decoding = [a, b, c]
    assert sched.select_victim(decoding) is b
    b.reservation = Reservation(blocks=[8, 9, 10, 11])
    assert sched.select_victim(decoding) is c
    b.reservation.closed = True
    assert sched.select_victim(decoding) is b
    b.table.blocks = [4, 8, 9]
    b.reservation = None
    assert sched._blocks_held(b) == sched._blocks_held(c)
    assert sched.select_victim(decoding) is c
    sched.preemptions[c.rid] = 2
    assert sched.select_victim(decoding) is b
    sched.preemptions[b.rid] = sched.preemptions[a.rid] = 2
    assert sched.select_victim(decoding) is None
    assert sched.select_victim([]) is None


def test_scheduler_victim_selection_closest_to_done_policy():
    sched = Scheduler(SchedulerConfig(preempt_after_iters=1,
                                      preempt_limit=2,
                                      victim_policy="closest-to-done"))
    a, b, c = _req(1, max_new=10), _req(2, max_new=10), _req(3, max_new=10)
    a.output_tokens = [0] * 3
    b.output_tokens = [0] * 8
    c.output_tokens = [0] * 5
    decoding = [a, b, c]
    assert sched.select_victim(decoding) is b
    d = _req(4, max_new=50)
    d.output_tokens = [0] * 40
    decoding = [a, b, c, d]
    assert sched.select_victim(decoding) is b
    c.output_tokens = [0] * 8
    assert sched.select_victim(decoding) is c
    sched.preemptions[c.rid] = 2
    assert sched.select_victim(decoding) is b
    sched.preemptions[b.rid] = 2
    assert sched.select_victim(decoding) is a
    sched.preemptions[a.rid] = sched.preemptions[d.rid] = 2
    assert sched.select_victim(decoding) is None
    assert sched.select_victim([]) is None


def test_preempt_requeue_is_front_and_not_a_retry():
    sched = Scheduler(SchedulerConfig(retry_limit=1))
    victim, waiting = _req(1), _req(2)
    sched.enqueue(waiting, 0.0)
    victim.state = State.DECODING
    for _ in range(5):
        sched.preempt_requeue(victim)
        assert sched.queue[0] is victim
        assert victim.state == State.QUEUED
        sched.queue.popleft()
    assert sched.retries == {}
    assert sched.preemptions[victim.rid] == 5
    assert sched.requeue(victim)
    sched.queue.popleft()
    assert not sched.requeue(victim)
    assert victim.state == State.FAILED
    assert sched.preemptions == {}


def test_storeless_oversized_head_fails_fast_queue_moves():
    sched = Scheduler(SchedulerConfig(max_batch_tokens=100,
                                      max_decode_batch=8,
                                      max_prefill_batch=4))
    big = Request(rid=1, system_tokens=np.zeros(200, np.int32),
                  chunk_tokens=[], question_tokens=np.zeros(1, np.int32),
                  max_new_tokens=4)
    small = _req(2)
    sched.enqueue(big, 0.0)
    sched.enqueue(small, 0.0)
    got = sched.next_prefills(0, 0)
    assert big.state == State.FAILED
    assert got == [small]
    assert not sched.queue


# ---- paged == arena under preemption (tests/test_paged_decode.py:143) ------

def test_paged_matches_arena_under_preemption(churn_runs):
    """Reclaim tears down block rows mid-flight and re-prefills re-enter
    the paged batch: the pressured trajectory equals the arena engine's
    under the same pressure, byte for byte, with 0 gather bytes."""
    a, p = churn_runs[("default", 20)], churn_runs[("paged", 20)]
    assert a["completed"] == 6 and a["failed"] == 0
    assert p["completed"] == 6 and p["failed"] == 0
    assert a["counters"]["preemptions"] > 0
    assert p["counters"]["preemptions"] == a["counters"]["preemptions"]
    assert a["outputs"] == p["outputs"]
    assert len(a["trace"]) == len(p["trace"]) > 0
    for step, (ta, tp) in enumerate(zip(a["trace"], p["trace"])):
        assert set(ta) == set(tp), f"step {step}: membership differs"
        for rid in ta:
            np.testing.assert_array_equal(ta[rid], tp[rid])
    assert set(a["final_kv"]) == set(p["final_kv"])
    for rid in a["final_kv"]:
        for xa, xp in zip(a["final_kv"][rid], p["final_kv"][rid]):
            np.testing.assert_array_equal(xa, xp)
    assert a["counters"]["decode_gather_bytes"] > 0
    assert p["counters"]["decode_gather_bytes"] == 0
    assert p["pool"]["free"] == p["pool"]["blocks"]


# ---- against the JAX engine ------------------------------------------------

@pytest.fixture(scope="module")
def jax_churn(world):
    """The pressured churn workload through the JAX engine (``dense``)."""
    jcfg, jparams = world[3], world[4]
    eng = j_build(JSpec(strategy="all", use_focus=False, pool_blocks=20,
                        decode_bucket_b=4, seq_bucket=512,
                        attn_impl="dense",
                        sched=JSched(max_batch_tokens=100_000,
                                     max_decode_batch=4,
                                     max_prefill_batch=2,
                                     preempt_after_iters=4),
                        trace_decode=True),
                  cfg=jcfg, params=jparams, store=None)
    kb = JKB(num_chunks=10, vocab_size=jcfg.vocab_size, seed=0)
    reqs = j_generate(kb, JWL(num_requests=6, qpm=1e9, seed=17,
                              k_chunks=3, max_new_tokens=4))
    for r, n in zip(reqs, (18, 18, 3, 5, 4, 6)):
        r.max_new_tokens = n
    stats = eng.run(reqs)
    return eng, stats, reqs


@pytest.mark.parametrize("route", list(ROUTES))
def test_pressured_run_matches_jax_engine(churn_runs, jax_churn, route):
    """Equal preemption counts, decode-batch membership at every step,
    plans and tokens; decode logits within 2e-4 of the JAX engine."""
    t = churn_runs[(route, 20)]
    eng_j, stats_j, reqs_j = jax_churn
    cj = eng_j.counters
    assert cj.preemptions > 0
    for k in ("preemptions", "preempt_block_recovered",
              "head_stall_iters_max"):
        assert t["counters"][k] == getattr(cj, k), k
    assert t["completed"] == stats_j.completed == 6
    assert t["failed"] == stats_j.failed == 0
    assert t["prefill_tokens_computed"] == stats_j.prefill_tokens_computed
    assert t["hits"] == [r.cache_hits for r in reqs_j]
    assert t["computed"] == [r.prefill_tokens_computed for r in reqs_j]
    assert t["outputs"] == [list(r.output_tokens) for r in reqs_j]
    assert len(t["trace"]) == len(eng_j.decode_trace) > 0
    for step, (tt, tj) in enumerate(zip(t["trace"], eng_j.decode_trace)):
        assert set(tt) == set(tj), f"step {step}: membership differs"
        for rid in tt:
            np.testing.assert_allclose(tt[rid], np.asarray(tj[rid]),
                                       **JAX_TOL,
                                       err_msg=f"step {step}, rid {rid}")


# ---- chip_smoke.py's phase 16, rehearsed on the CPU ------------------------

def _rehearse_pressure(npz, tmp):
    """``chip_smoke.run_pressure`` on tiny llama3-8b: the engines' spec on
    the CPU, the timers stubbed, and the four kernel wrappers routed
    through their launch hooks onto the plain versions (each counting its
    calls), so that the phase's recorders, counts and checks run as on
    the card."""
    from repro_torch.core import prefill
    from repro_torch.kernels.chunk_attention import ops as cops
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref, paged_decode_attention_ref
    from repro_torch.kernels.rope import ops as rops
    from repro_torch.serving import api

    sys.path.insert(0, ROOT)
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

    def call(what, entry, ptrs, ints, q, nsplit):
        ref = decode_attention_ref if entry == "decode_attention_fwd" \
            else paged_decode_attention_ref
        return ref(*ptrs, window=ints[-1])

    def decode_attention(q, k, v, q_pos, k_pos, *, window=0):
        B, H, D = q.shape
        decode_attention.launches += 1
        return dops._call("decode_attention", "decode_attention_fwd",
                          (q, k, v, q_pos, k_pos),
                          (B, k.shape[1], H, k.shape[2], D, int(window)),
                          q, 1)

    def paged_decode_attention(q, kb, vb, kp, rows, q_pos, *, window=0):
        B, H, D = q.shape
        NB, bs, Hkv = kb.shape[:3]
        paged_decode_attention.launches += 1
        return dops._call("paged_decode_attention",
                          "paged_decode_attention_fwd",
                          (q, kb, vb, kp, rows, q_pos),
                          (B, NB, rows.shape[1], bs, H, Hkv, Hkv, D,
                           int(window)), q, 1)

    def rope_np(cfg, k, pos, *, device, inverse=False):
        rops.rope.launches += 1
        return rops.rope(torch.from_numpy(np.array(k, np.float32)),
                         torch.from_numpy(np.asarray(pos, np.int32)),
                         theta=cfg.rope_theta, inverse=inverse).numpy()

    decode_attention.launches = paged_decode_attention.launches = 0
    spec_cls = api.EngineSpec
    api.EngineSpec = lambda **kw: spec_cls(**{**kw, "device": "cpu"})
    cs.cuda_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
    cs.device_ms = lambda fn, iters=20, warmup=3, windows=3: (fn(), 1.0)[1]
    torch.cuda.synchronize = lambda *a, **k: None
    cops._launch, cops.chunk_attention = chunk_launch, chunk_attention
    dops._call, dops.decode_attention = call, decode_attention
    dops.paged_decode_attention = paged_decode_attention
    prefill.rope_np = rope_np
    cfg = get_tiny("llama3-8b")
    leaves = np.load(npz, allow_pickle=True)["params"].item()
    params = TM.params_from_jax(cfg, leaves, "cpu")
    with torch.no_grad():
        return cs.run_pressure(cfg, params, tmp)


def test_chip_smoke_pressure_phase_rehearsal(world, tmp_path):
    npz = tmp_path / "params.npz"
    np.savez(npz, params=np.array(jax.tree.map(np.asarray, world[4]),
                                  dtype=object))
    out = run_pinned(__name__, tmp_path, "_rehearse_pressure", str(npz),
                     str(tmp_path))
    for route, r in out["preempt"].items():
        assert r["pressured"]["preemptions"] > 0, route
        assert r["logit_gap"] <= r["tol"] and r["kv_gap"] <= r["tol"]
    assert out["preempt"]["default"]["logit_bit_equal"]
    assert out["preempt"]["default"]["kv_bit_equal"]
    for route, r in out["zero_copy"].items():
        assert r["bit_equal"], route
        assert r["zero_copy"]["shared_seg_hits"] > 0
    assert out["incremental"]["bit_equal"]
    assert out["incremental"]["kv_bit_equal"]
    assert all(n > 0 for n in out["launches"].values())
    for name, r in out["kernels"].items():
        assert r["float32"]["err"] <= 3e-5, name

"""bf16 serving on the ``kernel`` route, the port against the reference:
tiny llama3-8b with ``cfg.replace(dtype="bfloat16",
param_dtype="bfloat16")``, the reference's bf16 weights carried across by
``params_from_jax``.

What the reference's bf16 path computes, and so what is compared: weights,
activations, q and the attention output in bf16; every cache on the
device fp32 (the executor's layouts, the engine's decode arena and pool
are host fp32), a fresh bf16 K/V cast into it as it is written; the chunk
and decode kernels take bf16 q over fp32 K/V, work in fp32 and write
their output in q's dtype; the chunk mass stays fp32. The JAX side's
Pallas kernels run in interpret mode on the CPU, the port's wrappers
their plain versions (the CUDA instantiations are held on the card,
``-m cuda``).

Tolerances, stated and argued:

* a mixed kernel's output against the reference kernel's: within one
  bf16 rounding of the value before rounding, ``|out - ref32| <= 2^-8
  |ref32| + 3e-5`` (``ONE_ROUNDING``; ref32 is the kernel on a q upcast
  to fp32, which the kernel does itself on load), and within one bf16
  ulp of the reference's rounded output (two roundings of values 1e-7
  apart can land one ulp apart); the fp32 mass within 3e-5, the fp32
  kernels' standard;
* the model and the engine: within ``BF16_GAP_FACTOR`` times the
  reference's own bf16-vs-fp32 gap on the same inputs (its fp32 model on
  the same bf16-rounded weights). The two frameworks round bf16 at
  different places (the order of the fp32 sums before a cast, whether a
  product is fused), so the fp32 parity standard (2e-4) cannot hold: one
  bf16 ulp at the logit scale here (2-4) is 2^-6. The reference's bf16
  run is itself that far from its fp32 run; the port's bf16 run may be
  as far again from the reference's, and twice the reference's own gap
  is the room for it. The gaps are printed (``-s``).
"""
import collections
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.core import prefill as JP
from repro.core.chunkstore import ChunkStore as JStore
from repro.core.tiers import TieredStore as JTiers
from repro.kernels.chunk_attention.ops import chunk_attention as j_chunk
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.models import model as JM
from repro.serving.api import EngineSpec as JSpec
from repro.serving.api import build_engine as j_build
from repro.serving.rag import KnowledgeBase as JKB
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.workload import WorkloadConfig as JWL
from repro.serving.workload import generate as j_generate
from repro_torch.configs import get_tiny
from repro_torch.core import prefill as TP
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.tiers import TieredStore
from repro_torch.kernels.chunk_attention import ops as cops
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import model as TM
from repro_torch.serving.api import EngineSpec, build_engine
from repro_torch.serving.rag import KnowledgeBase
from repro_torch.serving.request import State
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadConfig, generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (record_selections, score_gap,  # noqa: E402
                        selection_ties)

torch.set_num_threads(2)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
ONE_ROUNDING = 2.0 ** -8
ULP = 2.0 ** -7
KERNEL_ATOL = 3e-5
BF16_GAP_FACTOR = 2.0
# the routes the reference's engine cannot serve in bf16 (ROADMAP C12):
# (attn_impl, paged_decode)
C12_ROUTES = [(None, False), ("auto", False), ("dense", False),
              ("sharded", False), ("flash", False), ("flash_skip", False),
              ("flash_cp", False), ("paged", True), ("paged_kernel", True),
              ("kernel", True)]
N_REQ, MAX_NEW = 6, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _gap(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b").replace(**BF16)
    jcfg = j_tiny("llama3-8b").replace(**BF16)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = TM.params_from_jax(cfg, np_params, "cpu")
    # the reference's fp32 model on the same bf16-rounded weights
    jcfg32 = j_tiny("llama3-8b")
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    return cfg, jcfg, tparams, jparams, jcfg32, jparams32


# ---------------------------------------------------------------------------
# params_from_jax
# ---------------------------------------------------------------------------
def _leaves(p):
    return [p["embed"], p["unembed"], p["final_norm"]] + \
        [x for g in p["groups"] for _, x in sorted(g.items())] + \
        [x for t in p["tail"] for _, x in sorted(t.items())]


def test_params_from_jax_bf16_bit_for_bit(world):
    cfg, _jcfg, tparams, jparams, jcfg32, _j32 = world
    for t, j in zip(_leaves(tparams), _leaves(jax.tree.map(np.asarray,
                                                            jparams))):
        assert j.dtype == ml_dtypes.bfloat16
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                      .view(np.uint16), j.view(np.uint16))
    # fp32 leaves come across as they did: bit for bit, fp32
    j32 = jax.tree.map(np.asarray,
                       JM.init_params(jcfg32, jax.random.PRNGKey(1)))
    t32 = TM.params_from_jax(get_tiny("llama3-8b"), j32, "cpu")
    for t, j in zip(_leaves(t32), _leaves(j32)):
        assert t.dtype == torch.float32 and j.dtype == np.float32
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      j.view(np.uint32))


# ---------------------------------------------------------------------------
# the mixed kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------
def _hold_out(name, out, ref16, ref32):
    """bf16 ``out`` within one rounding of the reference's fp32 value and
    within one ulp of its bf16 output; returns the share equal to it."""
    assert out.dtype == torch.bfloat16
    o = _np(out)
    r32 = np.asarray(ref32, np.float32)
    r16 = np.asarray(ref16).astype(np.float32)
    bad = np.abs(o - r32) > ONE_ROUNDING * np.abs(r32) + KERNEL_ATOL
    assert not bad.any(), (name, float(np.abs(o - r32).max()))
    bad = np.abs(o - r16) > ULP * np.abs(r32) + KERNEL_ATOL
    assert not bad.any(), (name, float(np.abs(o - r16).max()))
    return float((o == r16).mean())


def _chunk_case(seed=0, A=40, S=96, H=8, Hkv=2, D=32, C=16, window=48):
    """Two packed requests (segments 0 / 1) over one KV row, padding rows
    and slots, C 16 chunks, a window."""
    rng = np.random.default_rng(seed)
    kpos = np.full(S, -1, np.int32)
    kseg = np.full(S, -1, np.int32)
    kch = np.full(S, C - 1, np.int32)
    qpos = np.full(A, -1, np.int32)
    qseg = np.full(A, -1, np.int32)
    k0 = a0 = 0
    for r, (sl, al) in enumerate(((60, 20), (30, 14))):
        kpos[k0:k0 + sl] = np.arange(sl)
        kseg[k0:k0 + sl] = r
        kch[k0:k0 + sl] = np.minimum(np.arange(sl) // 6, C - 2)
        qpos[a0:a0 + al] = np.sort(rng.choice(sl, al, replace=False))
        qseg[a0:a0 + al] = r
        k0 += sl
        a0 += al
    q = rng.normal(size=(A, H, D)).astype(ml_dtypes.bfloat16)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    return q, k, v, qpos, kpos, kch, qseg, kseg, C, window


def test_chunk_mixed_plain_vs_pallas():
    q, k, v, qpos, kpos, kch, qseg, kseg, C, window = _chunk_case()
    jargs = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
             jnp.asarray(kpos), jnp.asarray(kch))
    jkw = dict(q_seg=jnp.asarray(qseg), k_seg=jnp.asarray(kseg),
               num_chunks=C, window=window, block_q=16, block_k=32)
    j16, jm = j_chunk(jnp.asarray(q), *jargs, **jkw)
    j32, _ = j_chunk(jnp.asarray(q).astype(jnp.float32), *jargs, **jkw)
    assert j16.dtype == jnp.bfloat16 and jm.dtype == jnp.float32
    tq = torch.from_numpy(q.view(np.int16)).view(torch.bfloat16)
    out, mass = cops.chunk_attention(
        tq, *(torch.from_numpy(x) for x in (k, v, qpos, kpos, kch)),
        q_seg=torch.from_numpy(qseg), k_seg=torch.from_numpy(kseg),
        num_chunks=C, window=window)
    assert mass.dtype == torch.float32
    same = _hold_out("chunk", out, j16, j32)
    np.testing.assert_allclose(_np(mass), np.asarray(jm), rtol=0,
                               atol=KERNEL_ATOL)
    print(f"chunk bf16 q / fp32 K/V: {same:.4%} of outputs equal to the "
          f"Pallas kernel's, max |dmass| {_gap(mass, jm):.2e}")


def test_decode_mixed_plain_vs_pallas():
    rng = np.random.default_rng(1)
    B, S, H, Hkv, D = 3, 80, 8, 2, 32
    q = rng.normal(size=(B, H, D)).astype(ml_dtypes.bfloat16)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    lens = np.array([80, 33, 50])
    kpos = np.where(np.arange(S)[None] < lens[:, None], np.arange(S)[None],
                    -1).astype(np.int32)
    qpos = np.array([79, 32, -1], np.int32)        # row 2 masked
    for window in (0, 24):
        jargs = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                 jnp.asarray(kpos))
        j16 = j_decode(jnp.asarray(q), *jargs, window=window, block_k=32)
        j32 = j_decode(jnp.asarray(q).astype(jnp.float32), *jargs,
                       window=window, block_k=32)
        assert j16.dtype == jnp.bfloat16
        tq = torch.from_numpy(q.view(np.int16)).view(torch.bfloat16)
        out = dops.decode_attention(
            tq, *(torch.from_numpy(x) for x in (k, v, qpos, kpos)),
            window=window)
        same = _hold_out("decode", out, j16, j32)
        assert float(out[2].abs().max()) == 0.0
        print(f"decode bf16 q / fp32 K/V window {window}: {same:.4%} equal")


def test_wrappers_refuse_other_mixes():
    rng = np.random.default_rng(2)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    A, S, H, Hkv, D = 4, 8, 4, 2, 32
    q, k, v = f32(A, H, D), f32(S, Hkv, D), f32(S, Hkv, D)
    pos = torch.arange(S, dtype=torch.int32)
    bf = torch.bfloat16
    for qq, kk, vv in ((q, k.to(bf), v.to(bf)),          # fp32 q, bf16 K/V
                       (q.to(bf), k, v.to(bf)),          # K and V differ
                       (q.to(bf), k.to(bf), v),
                       (q.half(), k, v), (q, k.half(), v.half())):
        with pytest.raises(TypeError, match="the kernel takes"):
            cops.chunk_attention(qq, kk, vv, pos[:A], pos, pos * 0,
                                 num_chunks=4)
        with pytest.raises(TypeError, match="the kernel takes"):
            dops.decode_attention(qq[None, 0], kk[None], vv[None],
                                  pos[:1], pos[None])
    # the paged kernel takes no mix: a bf16 q over an fp32 pool (or the
    # reverse) is refused, and the message names the pairs it takes
    kb, vb = f32(4, 4, Hkv, D), f32(4, 4, Hkv, D)
    rows = torch.tensor([[0, 1]], dtype=torch.int32)
    kpb = torch.arange(16, dtype=torch.int32).view(4, 4)
    for qq, kk, vv in ((q[None, 0].to(bf), kb, vb),
                       (q[None, 0], kb.to(bf), vb.to(bf))):
        with pytest.raises(TypeError, match="q bfloat16 with K and V "
                           "bfloat16$"):
            dops.paged_decode_attention(qq, kk, vv, kpb, rows,
                                        torch.tensor([7], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the model on ``kernel`` in bf16, over fp32 caches
# ---------------------------------------------------------------------------
def _hold_gap(name, got, ref, ref32, gaps):
    """port vs reference bf16 within BF16_GAP_FACTOR x the reference's own
    bf16-vs-fp32 gap on the same value; the pair recorded in ``gaps``."""
    g, g_ref = _gap(got, ref), _gap(ref, ref32)
    gaps[name] = (g, g_ref)
    assert g <= BF16_GAP_FACTOR * g_ref, (name, g, g_ref)


def _print_gaps(what, gaps):
    print(f"{what}: port vs reference bf16 (reference bf16 vs fp32): "
          + ", ".join(f"{n} {g:.3e} ({r:.3e})" for n, (g, r) in
                      gaps.items()))


def _hold_caches(tag, tc, jc, jc32, gaps):
    for i, (tg, jg, jg32) in enumerate(zip(tc["groups"], jc["groups"],
                                           jc32["groups"])):
        for n in ("k", "v"):
            assert tg[n].dtype == torch.float32 and jg[n].dtype == \
                jnp.float32
            _hold_gap(f"{tag} cache {n}{i}", tg[n], jg[n], jg32[n], gaps)
        np.testing.assert_array_equal(_np(tg["pos"]), _np(jg["pos"]))


class _Sides:
    """The same steps through the port (bf16), the reference in bf16 and
    the reference in fp32 on the same bf16-rounded weights."""

    def __init__(self, world):
        self.cfg, self.jcfg, self.tp, self.jp, self.jcfg32, self.jp32 = world

    def cache(self, B, S):
        return (TM.init_cache(self.cfg, B, S, dtype="float32", device="cpu"),
                JM.init_cache(self.jcfg, B, S, dtype="float32"),
                JM.init_cache(self.jcfg32, B, S, dtype="float32"))

    def forward(self, caches, **kw):
        t = TM.forward(self.cfg, self.tp, cache=caches[0],
                       **{k: None if v is None else torch.from_numpy(v)
                          if isinstance(v, np.ndarray) else v
                          for k, v in kw.items()})
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        j = JM.forward(self.jcfg, self.jp, cache=caches[1], **jkw)
        j32 = JM.forward(self.jcfg32, self.jp32, cache=caches[2], **jkw)
        return t, j, j32


def test_model_kernel_bf16_prefill_with_stats(world):
    sides = _Sides(world)
    cfg = sides.cfg
    rng = np.random.default_rng(3)
    T, S = 24, 32
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    cid = (np.arange(S) // 6).astype(np.int32)[None].repeat(2, 0)
    pos = np.arange(T, dtype=np.int32)[None].repeat(2, 0)
    t, j, j32 = sides.forward(sides.cache(2, S), tokens=toks,
                              positions=pos, mode="prefill",
                              chunk_ids=cid, collect_stats=True,
                              attn_impl="kernel")
    assert t.logits.dtype == torch.bfloat16 and j.logits.dtype == \
        jnp.bfloat16
    assert t.stats.dtype == torch.float32
    gaps = {}
    _hold_gap("logits", t.logits, j.logits, j32.logits, gaps)
    _hold_gap("stats", t.stats, j.stats, j32.stats, gaps)
    _hold_caches("prefill", t.cache, j.cache, j32.cache, gaps)
    _print_gaps("prefill", gaps)


def _inject_world(sides, rng):
    """A system prefix of 4 tokens prefilled on each side, then a stored
    (de-roped) chunk of 10 tokens injected at positions 4-13 through each
    package's ``inject_chunk_kv`` into the fp32 layout, as the executor
    lays out a hit."""
    cfg = sides.cfg
    n_sys, n_chunk, S = 4, 10, 40
    sys_t = rng.integers(0, cfg.vocab_size, (1, n_sys)).astype(np.int32)
    chunk_t = rng.integers(0, cfg.vocab_size, (1, n_chunk)).astype(np.int32)
    # the stored chunk: the reference's bf16 K/V of the chunk alone, RoPE
    # removed, as the store keeps it (fp32)
    alone = JM.prefill(sides.jcfg, sides.jp, jnp.asarray(chunk_t),
                       cache_len=n_chunk)
    k_roped = np.asarray(alone.cache["groups"][0]["k"], np.float32)[:, 0]
    kv = {"k": TP.rope_np(cfg, k_roped, np.arange(n_chunk), device="cpu",
                          inverse=True),
          "v": np.asarray(alone.cache["groups"][0]["v"], np.float32)[:, 0]}
    rope_pos = np.arange(n_sys, n_sys + n_chunk, dtype=np.int32)
    caches = sides.cache(1, S)
    pos = np.arange(n_sys, dtype=np.int32)[None]
    caches = [r.cache for r in sides.forward(
        caches, tokens=sys_t, positions=pos, mode="prefill",
        attn_impl="kernel")]
    out = []
    for c, (k, v) in zip(caches, (
            TP.inject_chunk_kv(cfg, kv, rope_pos, device="cpu"),
            JP.inject_chunk_kv(sides.jcfg, kv, rope_pos),
            JP.inject_chunk_kv(sides.jcfg32, kv, rope_pos))):
        g = {n: np.array(c["groups"][0][n]) for n in ("k", "v", "pos")}
        g["k"][:, 0, n_sys:n_sys + n_chunk] = k
        g["v"][:, 0, n_sys:n_sys + n_chunk] = v
        g["pos"][:, 0, n_sys:n_sys + n_chunk] = rope_pos
        out.append(g)
    caches = ({"groups": [{n: torch.from_numpy(x) for n, x in
                           out[0].items()}], "tail": []},
              {"groups": [{n: jnp.asarray(x) for n, x in out[1].items()}],
               "tail": []},
              {"groups": [{n: jnp.asarray(x) for n, x in out[2].items()}],
               "tail": []})
    return caches, chunk_t, n_sys, n_chunk, S


def test_model_kernel_bf16_partial_then_decode(world):
    """A partial pass over the injected chunk (3 recomputed rows, 6 new
    tokens, 2 padding rows, stats), then 4 decode steps on the same
    fp32 cache."""
    sides = _Sides(world)
    cfg = sides.cfg
    rng = np.random.default_rng(4)
    caches, chunk_t, n_sys, n_chunk, S = _inject_world(sides, rng)
    rec = np.array([1, 4, 8])
    q0 = n_sys + n_chunk
    act_pos = np.concatenate([n_sys + rec, np.arange(q0, q0 + 6),
                              [-1, -1]]).astype(np.int32)[None]
    act_tok = np.concatenate([chunk_t[0, rec], rng.integers(
        0, cfg.vocab_size, 8)]).astype(np.int32)[None]
    seg = np.where(act_pos >= 0, 0, -1).astype(np.int32)
    kv_seg = np.where(np.arange(S) < q0 + 6, 0, -1).astype(np.int32)[None]
    cid = np.minimum(np.searchsorted([n_sys, q0], np.arange(S),
                                     side="right"), 2).astype(np.int32)[None]
    t, j, j32 = sides.forward(caches, tokens=act_tok, positions=act_pos,
                              mode="partial", chunk_ids=cid,
                              collect_stats=True, attn_impl="kernel",
                              slots=act_pos, seg_ids=seg, kv_seg=kv_seg)
    gaps = {}
    _hold_gap("logits", t.logits[:, :9], j.logits[:, :9],
              j32.logits[:, :9], gaps)
    _hold_gap("stats", t.stats[:, :, :9], j.stats[:, :, :9],
              j32.stats[:, :, :9], gaps)
    _hold_caches("partial", t.cache, j.cache, j32.cache, gaps)
    _print_gaps("partial with an injected chunk", gaps)
    caches = (t.cache, j.cache, j32.cache)
    gaps = {}
    for step in range(4):
        p = np.array([q0 + 6 + step], np.int32)
        tok = rng.integers(0, cfg.vocab_size, 1).astype(np.int32)
        t = TM.decode_step(cfg, sides.tp, torch.from_numpy(tok),
                           torch.from_numpy(p), caches[0],
                           attn_impl="kernel")
        j = JM.decode_step(sides.jcfg, sides.jp, jnp.asarray(tok),
                           jnp.asarray(p), caches[1], attn_impl="kernel")
        j32 = JM.decode_step(sides.jcfg32, sides.jp32, jnp.asarray(tok),
                             jnp.asarray(p), caches[2], attn_impl="kernel")
        _hold_gap(f"decode logits {step}", t.logits, j.logits, j32.logits,
                  gaps)
        caches = (t.cache, j.cache, j32.cache)
    _hold_caches("decode", *caches, gaps)
    _print_gaps("decode", gaps)


# ---------------------------------------------------------------------------
# the engine: Engine.run on ``kernel``, the port against the reference
# ---------------------------------------------------------------------------
def _engine_run(pkg, cfg, params, tmp, replay=None, attn_impl="kernel",
                paged_decode=False, n_req=N_REQ):
    """One engine of ``pkg`` ("port" or "jax") with its own fresh store
    over ``n_req`` requests of 3 chunks from a 24-chunk knowledge base
    (seed 1), 4 greedy tokens each, its executor's token choices recorded
    (and, with ``replay``, another run's choices taken in place of its
    own)."""
    port = pkg == "port"
    Store, Tiers = (ChunkStore, TieredStore) if port else (JStore, JTiers)
    store = Store(Tiers(1 << 28, 1 << 28, str(tmp), start_worker=False),
                  50, 4)
    spec = (EngineSpec if port else JSpec)(
        use_focus=False, pool_blocks=512, attn_impl=attn_impl,
        paged_decode=paged_decode,
        sched=(SchedulerConfig if port else JSched)(max_decode_batch=4),
        trace_decode=True, **(dict(device="cpu") if port else {}))
    eng = (build_engine if port else j_build)(spec, cfg=cfg, params=params,
                                              store=store)
    eng.executor.selections = record_selections(eng.executor)
    eng.executor.strategy_obj.replay = None if replay is None else \
        list(replay)
    kb = (KnowledgeBase if port else JKB)(num_chunks=24,
                                          vocab_size=cfg.vocab_size, seed=0)
    reqs = (generate if port else j_generate)(kb, (
        WorkloadConfig if port else JWL)(num_requests=n_req, qpm=1e9,
                                         seed=1, k_chunks=3,
                                         max_new_tokens=MAX_NEW))
    stats = eng.run(reqs)
    assert not eng.executor.strategy_obj.replay, "replayed choices left"
    return dict(eng=eng, stats=stats, reqs=reqs,
                sel=eng.executor.selections,
                trace=_per_rid(eng.decode_trace),
                tokens={r.rid: list(r.output_tokens) for r in reqs})


def _per_rid(trace):
    out = {}
    for step in trace:
        for rid, lg in step.items():
            out.setdefault(rid, []).append(np.asarray(lg, np.float32))
    return out


def _decode_gap(a, b):
    """Largest decode-logit gap between two runs, request by request,
    over the steps whose inputs agree (tokens equal so far)."""
    worst = 0.0
    for rid in a["trace"]:
        for i, (x, y) in enumerate(zip(a["trace"][rid], b["trace"][rid])):
            if a["tokens"][rid][:i + 1] != b["tokens"][rid][:i + 1]:
                break
            worst = max(worst, float(np.abs(x - y).max()))
    return worst


@pytest.fixture(scope="module")
def engines(world, tmp_path_factory):
    cfg, jcfg, tp, jp, jcfg32, jp32 = world
    tmp = tmp_path_factory.mktemp("bf16-engines")
    j16 = _engine_run("jax", jcfg, jp, tmp / "j16")
    j32 = _engine_run("jax", jcfg32, jp32, tmp / "j32")
    t16 = _engine_run("port", cfg, tp, tmp / "t16", replay=j16["sel"])
    t32 = _engine_run("port", get_tiny("llama3-8b"), _fp32(tp), tmp / "t32",
                      replay=t16["sel"])
    return j16, j32, t16, t32


def test_engine_kernel_bf16_matches_jax(engines):
    j16, j32, t16, t32 = engines
    st_t, st_j = t16["stats"], j16["stats"]
    assert st_t.completed == st_j.completed == N_REQ
    assert st_t.failed == st_j.failed == 0
    assert st_t.prefill_tokens_total == st_j.prefill_tokens_total
    assert st_t.prefill_tokens_computed == st_j.prefill_tokens_computed
    assert st_t.prefill_tokens_computed < st_t.prefill_tokens_total
    for rt, rj in zip(t16["reqs"], j16["reqs"]):
        assert rt.state == State.DONE and rj.state.name == "DONE"
        assert rt.cache_hits == rj.cache_hits, rt.rid
        assert rt.prefill_tokens_computed == rj.prefill_tokens_computed
    assert any(r.cache_hits for r in t16["reqs"])
    # the port took the reference's choices; its own may differ from them
    # only at a near tie, within the room the reference's own bf16 scores
    # leave (BF16_GAP_FACTOR x their gap to its fp32 scores)
    floor = BF16_GAP_FACTOR * score_gap(j16["sel"], j32["sel"],
                                        lambda s: s.inter)
    ties, tie_tokens = selection_ties("bf16 engine", t16["sel"], j16["sel"],
                                      lambda s: s.inter, floor)
    # decode logits within BF16_GAP_FACTOR x the reference's own bf16 vs
    # fp32 gap; greedy tokens equal wherever the reference's top-two gap
    # exceeds that tolerance
    ref_gap = _decode_gap(j16, j32)
    tol = BF16_GAP_FACTOR * ref_gap
    assert set(t16["trace"]) == set(j16["trace"])
    worst, flips = 0.0, 0
    for rid, steps in j16["trace"].items():
        for i, (a, b) in enumerate(zip(t16["trace"][rid], steps)):
            if t16["tokens"][rid][:i + 1] != j16["tokens"][rid][:i + 1]:
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] <= tol, (rid, i, top2)
                flips += 1
                break
            worst = max(worst, float(np.abs(a - b).max()))
        else:
            assert t16["tokens"][rid] == j16["tokens"][rid]
    assert worst <= tol, (worst, ref_gap)
    print(f"bf16 engine on kernel: port vs reference decode logits "
          f"{worst:.3e}, the reference's bf16 vs fp32 {ref_gap:.3e} "
          f"(tol {tol:.3e}); the port's bf16 vs its own fp32 on the same "
          f"weights {_decode_gap(t16, t32):.3e}; score floor {floor:.3e}, "
          f"{ties} selection(s) ({tie_tokens} tokens) differ at a near "
          f"tie; {flips} greedy flip(s) at a near tie; tokens equal for "
          f"{sum(t16['tokens'][r] == j16['tokens'][r] for r in t16['tokens'])}"
          f"/{N_REQ} requests; computed / total prefill tokens "
          f"{st_t.prefill_tokens_computed} / {st_t.prefill_tokens_total}")


def _fp32(p):
    return {"embed": p["embed"].float(), "unembed": p["unembed"].float(),
            "final_norm": p["final_norm"].float(),
            "groups": [{n: x.float() for n, x in g.items()}
                       for g in p["groups"]],
            "tail": [{n: x.float() for n, x in t.items()}
                     for t in p["tail"]]}


def test_engine_gap_within_forward_gap(world, engines):
    """The rule chip_smoke's phase 19 holds the card's bf16 engine to,
    held here on both packages: the engine's bf16-vs-fp32 decode-logit gap
    (on the same bf16-rounded weights) within ``BF16_FORWARD_FACTOR``
    times the plain train-mode forward's bf16-vs-fp32 gap on
    ``FORWARD_TOKENS`` of random tokens. The reference's own gap meets it,
    so the rule is the reference's behaviour and not the port's."""
    import chip_smoke as cs
    cfg, jcfg, tp, jp, jcfg32, jp32 = world
    j16, j32, t16, t32 = engines
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, cs.FORWARD_TOKENS).astype(np.int32)
    lo16 = JM.forward(jcfg, jp, tokens=jnp.asarray(toks),
                      attn_impl="dense").logits
    lo32 = JM.forward(jcfg32, jp32, tokens=jnp.asarray(toks),
                      attn_impl="dense").logits
    ref_fwd = _gap(lo16, lo32)
    port_fwd, _ = cs.forward_gap(get_tiny("llama3-8b"), _fp32(tp), cfg, tp,
                                 "cpu")
    ref_eng, port_eng = _decode_gap(j16, j32), _decode_gap(t16, t32)
    print(f"engine bf16-vs-fp32 decode-logit gap over the plain forward's: "
          f"reference {ref_eng:.3e} / {ref_fwd:.3e} = "
          f"{ref_eng / ref_fwd:.2f}, port {port_eng:.3e} / {port_fwd:.3e} "
          f"= {port_eng / port_fwd:.2f} (limit {cs.BF16_FORWARD_FACTOR:g})")
    assert 0 < ref_eng <= cs.BF16_FORWARD_FACTOR * ref_fwd
    assert 0 < port_eng <= cs.BF16_FORWARD_FACTOR * port_fwd
    assert port_fwd <= BF16_GAP_FACTOR * ref_fwd


@pytest.mark.parametrize("attn_impl,paged_decode", C12_ROUTES)
def test_c12_routes_refused_in_both(world, tmp_path, attn_impl,
                                    paged_decode):
    """The routes the reference's engine cannot serve in bf16: it fails
    in the first prefill (``paged_decode`` on ``kernel``: the first
    decode step) with a ``TypeError``, fp32 attention meeting the bf16
    residual; the port refuses each when the engine is built."""
    cfg, jcfg, tp, jp, _c32, _p32 = world
    with pytest.raises(ValueError, match="C12"):
        _engine_run("port", cfg, tp, tmp_path / "t", attn_impl=attn_impl,
                    paged_decode=paged_decode, n_req=1)
    with pytest.raises(TypeError, match="carry input and carry output"):
        _engine_run("jax", jcfg, jp, tmp_path / "j", attn_impl=attn_impl,
                    paged_decode=paged_decode, n_req=1)


# ---------------------------------------------------------------------------
# chip_smoke.py's bf16 phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("planted", [False, True])
def test_chip_smoke_bf16_phase_rehearsal(tmp_path, monkeypatch, planted):
    """``chip_smoke.run_bf16`` on tiny llama3-8b on the CPU: the timers
    and the card's memory counters stubbed, the chunk and decode wrappers
    routed through their launch hooks onto the plain versions (each
    counting its launches by instantiation, as on the card), so that the
    phase's recorders, launch gates, gap and mixed-kernel checks run as
    they do there. ``planted``: the bf16 decode output of layer 0 zeroed
    (a fault of the bf16 path alone), which the phase's bound on the
    A16-A32 gap must refuse."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    from repro_torch.serving import api

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
        if planted and q.dtype == torch.bfloat16:
            decode_attention.bf16_calls += 1
            if (decode_attention.bf16_calls - 1) % cfg.num_layers == 0:
                out = torch.zeros_like(out)
        return out

    for f in (chunk_attention, decode_attention):
        f.launches, f.launches_by_type = 0, collections.Counter()
    decode_attention.bf16_calls = 0
    spec_cls = api.EngineSpec
    monkeypatch.setattr(api, "EngineSpec",
                        lambda **kw: spec_cls(**{**kw, "device": "cpu"}))
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3,
                        windows=3: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(cops, "_launch", chunk_launch)
    monkeypatch.setattr(cops, "chunk_attention", chunk_attention)
    monkeypatch.setattr(dops, "_call", call)
    monkeypatch.setattr(dops, "decode_attention", decode_attention)
    cfg = get_tiny("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    if planted:
        with torch.no_grad(), pytest.raises(RuntimeError,
                                            match="decode logit gap"):
            cs.run_bf16(cfg, params, str(tmp_path))
        return
    with torch.no_grad():
        out = cs.run_bf16(cfg, params, str(tmp_path))
    for name in ("chunk_attention", "decode_attention"):
        assert out["launches"][name] == {cs.MIXED: out["want"][name]} and \
            out["want"][name] > 0
        row = out["kernels"][name]
        assert row["ratio"] <= 1.0 and row["calls"] > 0
    assert out["A16"]["completed"] == out["A32"]["completed"] == 12
    assert out["compared_steps"] > 0
    assert 0 < out["logit_gap"] <= out["logit_limit"] == \
        cs.BF16_FORWARD_FACTOR * out["forward_gap"]
    assert params["embed"].dtype == torch.float32 and torch.equal(
        params["embed"], params["embed"].bfloat16().float())
    print(f"rehearsal: A16 vs A32 {out['logit_gap']:.3e} (the plain "
          f"forward's bf16 gap {out['forward_gap']:.3e}), parts "
          f"{out['greedy_parts']}, plans differ {out['plan_diff']}")

"""Port model vs the JAX model on tiny llama3-8b, through
``params_from_jax``: ``forward`` logits, caches and Cache-Craft stats in
prefill, partial, decode and paged-decode modes, on the ``dense`` and
``kernel`` backends (and ``paged`` / ``paged_kernel``), at 2e-4.

The JAX ``kernel`` backend runs its Pallas kernels in interpret mode on
the CPU; the port's ``kernel`` backend runs the plain versions there
(the CUDA kernels run on the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as j_tiny
from repro.models import model as JM
from repro_torch.configs import get_tiny
from repro_torch.models import model as TM

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _close_cache(tc, jc):
    for tg, jg in zip(tc["groups"], jc["groups"]):
        for n in jg:
            if n in ("pos", "ppos"):
                np.testing.assert_array_equal(_np(tg[n]), _np(jg[n]))
            else:
                _close(tg[n], jg[n])


@pytest.fixture(scope="module")
def world():
    cfg = get_tiny("llama3-8b")
    jcfg = j_tiny("llama3-8b")
    assert cfg.num_layers == jcfg.num_layers and cfg.d_model == jcfg.d_model
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # non-zero norm weights so the 1 + w scale is exercised
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(np.asarray, jparams)
    for g in np_params["groups"]:
        for n in ("ln1", "ln2"):
            g[n] = (rng.normal(size=g[n].shape) * 0.1).astype(np.float32)
    np_params["final_norm"] = (rng.normal(size=np_params["final_norm"]
                                          .shape) * 0.1).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TM.params_from_jax(cfg, np_params, "cpu")
    return cfg, jcfg, tparams, jparams


def test_params_from_jax_layout(world):
    cfg, _jcfg, tp, jp = world
    assert len(tp["groups"]) == len(cfg.pattern)
    for n, x in jp["groups"][0].items():
        assert tuple(tp["groups"][0][n].shape) == x.shape
        assert x.shape[0] == cfg.n_groups
    assert tp["tail"] == [] and tp["embed"].shape == jp["embed"].shape


def test_init_params_shapes_and_generator(world):
    cfg, _jcfg, tp, _jp = world
    a = TM.init_params(cfg, torch.Generator().manual_seed(3))
    b = TM.init_params(cfg, torch.Generator().manual_seed(3))
    for n, x in tp["groups"][0].items():
        assert a["groups"][0][n].shape == x.shape
        torch.testing.assert_close(a["groups"][0][n], b["groups"][0][n],
                                   rtol=0, atol=0)
    # fan-in scaled: wq entries ~ N(0, 1/d_model)
    sd = float(a["groups"][0]["wq"].std())
    assert abs(sd * np.sqrt(cfg.d_model) - 1.0) < 0.1


def _prefill_inputs(cfg, T=24, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    cid = (np.arange(T) // 6).astype(np.int32)[None].repeat(2, 0)
    return toks, cid


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_prefill_logits_cache_stats(world, impl):
    cfg, jcfg, tp, jp = world
    toks, cid = _prefill_inputs(cfg)
    t = TM.prefill(cfg, tp, torch.from_numpy(toks),
                   chunk_ids=torch.from_numpy(cid), collect_stats=True,
                   attn_impl=impl, cache_len=24)
    j = JM.prefill(jcfg, jp, jnp.asarray(toks), chunk_ids=jnp.asarray(cid),
                   collect_stats=True, attn_impl=impl, cache_len=24)
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)
    _close(t.stats, j.stats)
    if impl == "dense":
        _close(t.key_stats, j.key_stats)
    else:   # the kernel contract: no key-side mass
        assert float(t.key_stats.abs().sum()) == 0.0


def _partial_world(cfg, jcfg, tp, jp, seed=4):
    """A cache pre-populated by a dense prefill of the first 20 tokens,
    then a partial pass recomputing scattered rows + 6 new tokens, as the
    executor does (explicit write slots, segment ids, padding rows)."""
    rng = np.random.default_rng(seed)
    T0 = 20
    toks0 = rng.integers(0, cfg.vocab_size, (1, T0)).astype(np.int32)
    pre_t = TM.prefill(cfg, tp, torch.from_numpy(toks0), cache_len=40)
    pre_j = JM.prefill(jcfg, jp, jnp.asarray(toks0), cache_len=40)
    act_pos = np.concatenate([[3, 7, 11], np.arange(T0, T0 + 6),
                              [-1, -1, -1]]).astype(np.int32)[None]
    act_tok = rng.integers(0, cfg.vocab_size, act_pos.shape).astype(np.int32)
    seg = np.where(act_pos >= 0, 0, -1).astype(np.int32)
    kv_seg = np.zeros((1, 40), np.int32)
    kv_seg[:, T0 + 6:] = -1
    cid = (np.arange(40) // 8).astype(np.int32)[None]
    return pre_t, pre_j, act_tok, act_pos, seg, kv_seg, cid


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_partial_prefill(world, impl):
    cfg, jcfg, tp, jp = world
    pre_t, pre_j, tok, pos, seg, kv_seg, cid = _partial_world(cfg, jcfg, tp,
                                                             jp)
    t = TM.forward(cfg, tp, tokens=torch.from_numpy(tok),
                   positions=torch.from_numpy(pos), mode="partial",
                   cache=pre_t.cache, chunk_ids=torch.from_numpy(cid),
                   collect_stats=True, attn_impl=impl,
                   slots=torch.from_numpy(pos), seg_ids=torch.from_numpy(seg),
                   kv_seg=torch.from_numpy(kv_seg))
    j = JM.forward(jcfg, jp, tokens=jnp.asarray(tok),
                   positions=jnp.asarray(pos), mode="partial",
                   cache=pre_j.cache, chunk_ids=jnp.asarray(cid),
                   collect_stats=True, attn_impl=impl,
                   slots=jnp.asarray(pos), seg_ids=jnp.asarray(seg),
                   kv_seg=jnp.asarray(kv_seg))
    _close(t.logits[:, :9], j.logits[:, :9])
    _close_cache(t.cache, j.cache)
    _close(t.stats, j.stats)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_decode_step_arena_with_masked_row(world, impl):
    cfg, jcfg, tp, jp = world
    toks, _ = _prefill_inputs(cfg, T=16, seed=6)
    pre_t = TM.prefill(cfg, tp, torch.from_numpy(toks), cache_len=32)
    pre_j = JM.prefill(jcfg, jp, jnp.asarray(toks), cache_len=32)
    nxt = np.array([5, 9], np.int32)
    pos = np.array([16, -1], np.int32)           # row 1 masked
    t = TM.decode_step(cfg, tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                       pre_t.cache, decode_slot=torch.from_numpy(pos),
                       attn_impl=impl)
    j = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jnp.asarray(pos),
                       pre_j.cache, decode_slot=jnp.asarray(pos),
                       attn_impl=impl)
    _close(t.logits[0], j.logits[0])
    _close_cache(t.cache, j.cache)


def _pool_twin(cfg, seed=8):
    """A flat pool twin (NB blocks of bs slots) holding two requests'
    prefixes in scattered blocks, with block rows and slot rows."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    NB, bs = 12, 4
    k = rng.normal(size=(L, NB * bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(L, NB * bs, Hkv, D)).astype(np.float32)
    ppos = np.full(NB * bs, -1, np.int32)
    blocks = [[7, 2, 9], [4, 0]]
    lens = [10, 6]
    S = 16
    rows = np.full((2, S), -1, np.int32)
    brows = np.full((2, 4), -1, np.int32)
    for b, (blk, n) in enumerate(zip(blocks, lens)):
        slots = np.concatenate([np.arange(x * bs, (x + 1) * bs)
                                for x in blk])[:n]
        ppos[slots] = np.arange(n)
        rows[b, :n] = slots
        brows[b, :len(blk)] = blk
    # append slots: the next free slot of each request's last block
    app = np.array([9 * bs + 2, 0 * bs + 2], np.int32)
    return k, v, ppos, rows, brows, app, lens, bs


def _twin_cache(mod, k, v, ppos, conv):
    return {"groups": [{"kp": conv(k), "vp": conv(v),
                        "ppos": conv(np.broadcast_to(
                            ppos, (k.shape[0],) + ppos.shape).copy())}],
            "tail": []}


@pytest.mark.parametrize("impl", ["paged", "paged_kernel"])
def test_paged_decode_step(world, impl):
    cfg, jcfg, tp, jp = world
    k, v, ppos, rows, brows, app, lens, bs = _pool_twin(cfg)
    nxt = np.array([3, 11], np.int32)
    pos = np.array(lens, np.int32)
    # splice the append slot in at the logical position (paged_decode_fn)
    rows2 = rows.copy()
    rows2[np.arange(2), pos] = app
    tc = _twin_cache(TM, k, v, ppos, lambda x: torch.from_numpy(
        np.ascontiguousarray(x)))
    jc = _twin_cache(JM, k, v, ppos, jnp.asarray)
    t = TM.decode_step(cfg, tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                       tc, decode_slot=torch.from_numpy(app), attn_impl=impl,
                       paged_rows=torch.from_numpy(rows2),
                       paged_block_rows=torch.from_numpy(brows),
                       paged_block_size=bs)
    j = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                       decode_slot=jnp.asarray(app), attn_impl=impl,
                       paged_rows=jnp.asarray(rows2),
                       paged_block_rows=jnp.asarray(brows),
                       paged_block_size=bs)
    _close(t.logits, j.logits)
    _close_cache(t.cache, j.cache)
